"""The port's profiling helpers (`utils/profiling.py`), on the CPU:
`chained_timer`'s contract, the JAX package's (`stereoanywhere_tpu/utils/
profiling.py`): n_chain serial calls a run, every floating-point argument
perturbed by the carried sum of the earlier outputs' means times 1e-12,
one sync at a run's end, the round trip of an empty sync subtracted, the
median per-call seconds and each run's sample; and `trace`'s Chrome trace.
"""
import json

import numpy as np
import pytest
import torch

from stereoanywhere_tpu_torch.utils import profiling


class _Clock:
    """perf_counter that moves 0.25 s a read and `per_call` s a call of the
    timed function, so that every number the timer reports is exact."""

    def __init__(self, per_call: float):
        self.now, self.per_call = 0.0, per_call

    def __call__(self):
        t = self.now
        self.now += 0.25
        return t


def test_samples_median_and_the_round_trip(monkeypatch):
    clock = _Clock(1.5)
    monkeypatch.setattr(profiling.time, "perf_counter", clock)

    def fn(x):
        clock.now += clock.per_call
        return x * 2

    x = torch.ones(3, dtype=torch.float64)
    median, samples = profiling.chained_timer(fn, x, n_chain=4, repeats=5, return_samples=True)
    # a run reads the clock twice (0.25 between the reads, which the round trip of the empty sync also
    # takes) around 4 calls of 1.5 s: the corrected time a call is exactly 1.5
    assert len(samples) == 5
    assert samples == [1.5] * 5 and median == 1.5
    assert profiling.chained_timer(fn, x, n_chain=2, repeats=3) == 1.5


def test_the_perturbation_is_chained_through_the_outputs():
    seen = []

    def fn(w, x, k, y):
        seen.append((w.clone(), x.clone(), k, y.clone()))
        return {"a": x * 3.0, "b": [y + 1.0, "not a tensor"]}

    w = torch.full((2,), 5.0, dtype=torch.float64)
    x = torch.tensor([1.0, 2.0], dtype=torch.float64)
    y = np.array([0.5, -0.25, 4.0])  # numpy floats become tensors and are perturbed too
    n_chain, repeats = 3, 2
    profiling.chained_timer(fn, x, 7, y, n_chain=n_chain, repeats=repeats, const_args=(w,))
    assert len(seen) == n_chain * (1 + repeats)  # the warm-up run, then the timed ones
    for run in range(1 + repeats):
        acc = torch.zeros((), dtype=torch.float32)  # the carry is f32, as JAX's
        for i in range(n_chain):
            sw, sx, k, sy = seen[run * n_chain + i]
            assert k == 7 and torch.equal(sw, w)  # constants and integers pass as they are
            eps = (acc * 1e-12).double()
            assert torch.equal(sx, x + eps) and torch.equal(sy, torch.from_numpy(y) + eps)
            assert i == 0 or eps != 0
            acc = acc + ((sx * 3.0).float().mean() + (sy + 1.0).float().mean())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "logs")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = list((tmp_path / "logs").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_real_timing_is_positive_and_keeps_dtypes(dtype):
    dtypes = []

    def fn(x):
        dtypes.append(x.dtype)
        return x @ x

    x = torch.randn(32, 32).to(dtype)
    median, samples = profiling.chained_timer(fn, x, n_chain=2, repeats=2, return_samples=True)
    assert median >= 0 and len(samples) == 2 and all(s >= 0 for s in samples)
    assert set(dtypes) == {dtype}
