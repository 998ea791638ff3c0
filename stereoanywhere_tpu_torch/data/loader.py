"""Threaded prefetching batch loader, a copy of the JAX package's
`data/loader.py`: the counterpart of the reference's `DataLoader(num_workers=
...)` (reference train.py:189-207).

Worker threads build batches ahead of the consumer; the port's readers
decode through PIL (the JAX package's native decoder is not ported), which
releases the GIL for much of a PNG decode.

Determinism contract: the SAMPLE ORDER is exactly the synchronous loop's
(a permutation of len(dataset) by `seed`, wrapped modulo, from
`start_step`), and batches are delivered strictly in step order.
Augmentation randomness is per worker thread (the independence the
reference accepts through its worker seeding, base_dataset.py:65-74).
"""
from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np


def default_collate(samples: Sequence[dict]) -> dict[str, np.ndarray]:
    """Stack the trainer's batch keys (`cli train`'s contract): mono maps
    fall back to zeros when the dataset has no precomputed mono."""
    return {
        "im2_aug": np.stack([s["im2_aug"] for s in samples]),
        "im3_aug": np.stack([s["im3_aug"] for s in samples]),
        "mono2": np.stack([s.get("im2_mono", s["gt"] * 0) for s in samples]),
        "mono3": np.stack([s.get("im3_mono", s["gt_right"] * 0) for s in samples]),
        "gt": np.stack([s["gt"] for s in samples]),
        "validgt": np.stack([s["validgt"] for s in samples]),
        "gt_right": np.stack([s["gt_right"] for s in samples]),
        "validgt_right": np.stack([s["validgt_right"] for s in samples]),
    }


class PrefetchLoader:
    """Iterate batches [start_step, total_steps) with worker-thread prefetch.

    with PrefetchLoader(ds, batch_size=2, total_steps=1000) as loader:
        for step, batch in loader:
            ...
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        total_steps: int,
        seed: int = 0,
        start_step: int = 0,
        num_threads: int = 4,
        lookahead: int = 8,
        collate: Callable[[Sequence[dict]], dict] | None = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        """`shard_index`/`shard_count`: input sharding over processes — each
        builds the SAME global step order (same seed and permutation) and
        loads only its `batch_size/shard_count` slice of each step's global
        batch, so the shards together are the single-process order."""
        assert batch_size % shard_count == 0, (batch_size, shard_count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // shard_count
        self.shard_index = shard_index
        self.total_steps = total_steps
        self.start_step = start_step
        self.collate = collate or default_collate
        self.order = np.random.default_rng(seed).permutation(len(dataset))
        self.lookahead = max(lookahead, 1)
        self.num_threads = max(num_threads, 0)

        self._lock = threading.Condition()
        self._next_sched = start_step
        self._next_deliver = start_step
        self._ready: dict[int, dict] = {}
        self._errors: list[BaseException] = []
        self._closed = False
        self._threads: list[threading.Thread] = []
        if self.num_threads > 0:
            for i in range(self.num_threads):
                t = threading.Thread(target=self._worker, name=f"prefetch-{i}", daemon=True)
                t.start()
                self._threads.append(t)

    # -- internals --------------------------------------------------------
    def _indices(self, step: int) -> list[int]:
        n = len(self.dataset)
        base = step * self.batch_size + self.shard_index * self.local_batch
        return [int(self.order[(base + i) % n]) for i in range(self.local_batch)]

    def _build(self, step: int) -> dict:
        samples = [self.dataset[i] for i in self._indices(step)]
        return self.collate(samples)

    def _worker(self):
        while True:
            with self._lock:
                while (
                    not self._closed
                    and self._next_sched < self.total_steps
                    and self._next_sched >= self._next_deliver + self.lookahead
                ):
                    self._lock.wait()
                if self._closed or self._next_sched >= self.total_steps:
                    return
                step = self._next_sched
                self._next_sched += 1
            try:
                batch = self._build(step)
            except BaseException as e:  # surfaced to the consumer
                with self._lock:
                    self._errors.append(e)
                    self._lock.notify_all()
                return
            with self._lock:
                self._ready[step] = batch
                self._lock.notify_all()

    # -- iteration --------------------------------------------------------
    def __iter__(self):
        step = self._next_deliver
        while step < self.total_steps:
            if self.num_threads == 0:
                batch = self._build(step)
            else:
                with self._lock:
                    while step not in self._ready and not self._errors and not self._closed:
                        self._lock.wait()
                    if self._errors:
                        raise self._errors[0]
                    if self._closed:
                        return
                    batch = self._ready.pop(step)
                    self._next_deliver = step + 1
                    self._lock.notify_all()
            yield step, batch
            step += 1

    # -- lifecycle --------------------------------------------------------
    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
