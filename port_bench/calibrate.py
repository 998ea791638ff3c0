"""The readings that a cell's output-check limit is set from, on the card.

    python3 port_bench/calibrate.py --workload NAME --seeds 11 12 ... [--requests 16] [--control]

One process builds the cell's program once; for each seed it draws that
seed's weights into it in place (the captured graph reads them), draws the
seed's pool, serves `--requests` pairs in the closed loop and compares
every answer of the pairs drawn for the check with the f32 reference, in
units of the bf16 yardstick's gap, as a run does: the program's reading.  With `--control`, the reference with
every product's operands in float8 e4m3 is compared the same way: the
control's reading, which the limit has to refuse.  One JSON line a seed,
then a summary line.  The benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def looks(answers, refs) -> dict:
    """Statistics of |served - reference| in px beside the compared number,
    worst over the answers: the look that chose and explains it."""
    import numpy as np

    out = {}
    for p, ref in refs.items():
        for a in answers[p]:
            gap = np.abs(a.astype(np.float64) - ref)
            stats = {"epe": gap.mean(), "median": np.median(gap), "p90": np.quantile(gap, 0.9),
                     "p99": np.quantile(gap, 0.99),
                     "max": gap.max(), "rms": np.sqrt((gap ** 2).mean()), "bad1_pct": 100 * (gap > 1).mean(),
                     "bad3_pct": 100 * (gap > 3).mean(), "rel_mean": gap.mean() / np.abs(ref).mean(),
                     "ref_mean": np.abs(ref).mean(), "ref_std": ref.std()}
            for k, v in stats.items():
                out[k] = max(out.get(k, float("-inf")), round(float(v), 5))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--requests", type=int, default=16)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from port_bench import check, harness, traffic
    from stereoanywhere_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    bench = harness.load_benchmark(ROOT)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg, mix = harness.config_of(bench, cell["config"], ROOT), harness.traffic_of(cell["traffic"], ROOT)
    build.build()
    pipe = harness.build_program(cfg, dev, args.seeds[0])
    program, control = [], []
    for seed in args.seeds:
        harness.draw_weights(pipe.stereo, pipe.mono, cfg, seed)
        pool = traffic.make_pool(mix, seed, dev)
        checked = traffic.check_indices(mix, seed)
        answers = defaultdict(list)
        for i in range(args.requests):
            p = i % len(pool)
            out = pipe(*pool[p]).cpu().numpy()
            if p in checked:
                answers[p].append(out)
        t = time.perf_counter()
        refs = harness.reference_answers(cfg, pool, checked, dev, seed)
        yards = harness.reference_answers(cfg, pool, checked, dev, seed, torch.bfloat16)
        row = {"seed": seed, "program": check.compare(answers, refs, yards), "reference_s": time.perf_counter() - t,
               "look": {"program": looks(answers, refs), "yardstick": looks({p: [yards[p]] for p in checked}, refs)}}
        program.append(row["program"]["epe_bf16_units"])
        if args.control:
            low = harness.reference_answers(cfg, pool, checked, dev, seed, torch.float8_e4m3fn)
            row["control"] = check.compare({p: [low[p]] for p in checked}, refs, yards)
            row["look"]["control"] = looks({p: [low[p]] for p in checked}, refs)
            control.append(row["control"]["epe_bf16_units"])
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(dev), "seeds": len(args.seeds),
                      "program_max": max(program), "control_min": min(control) if control else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
