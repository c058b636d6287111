"""Deterministic, resumable, prefetching data pipeline — the port of
``repro.data.pipeline``.

Batches are a pure function of (seed, step) — the restart-replay contract
(the trainer restores step k, the pipeline regenerates batch k
bitwise).  A background thread keeps ``prefetch`` batches ahead of the
consumer, the host-side overlap with device compute.  Batches are numpy
arrays, as ``data.synthetic`` and ``graphs.sampler`` draw them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from repro_torch.data import synthetic as syn


class PrefetchingIterator:
    """Wraps a (step -> batch) function with background prefetch."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 prefetch: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._make(step))
            except Exception as e:  # noqa: BLE001 — surface in consumer
                item = ("error", e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "error":
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if step == "error":
            raise RuntimeError("data pipeline worker failed") from batch
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def lm_token_stream(cfg, batch: int, seq: int, *, seed: int = 0,
                    start_step: int = 0, prefetch: int = 2):
    """Synthetic LM token batches, deterministic per (seed, step)."""
    return PrefetchingIterator(
        lambda step: syn.lm_train_batch(cfg, batch, seq,
                                        seed=seed * 1_000_003 + step),
        start_step=start_step, prefetch=prefetch)


def recsys_stream(cfg, batch: int, *, seed: int = 0, start_step: int = 0,
                  prefetch: int = 2):
    return PrefetchingIterator(
        lambda step: syn.recsys_batch(cfg, batch, step="train",
                                      seed=seed * 1_000_003 + step),
        start_step=start_step, prefetch=prefetch)


def graph_minibatch_stream(sampler, batch_nodes: int, fanouts, *,
                           n_pad: int, e_pad: int, d_feat: int,
                           seed: int = 0, start_step: int = 0,
                           prefetch: int = 2):
    """Sampled-subgraph batches via ``graphs.sampler.NeighborSampler``:
    step k draws ``batch_nodes`` seeds from ``seed * 7_777_777 + k`` and
    samples with ``seed * 13 + k``, as the JAX stream does."""
    def make(step):
        rng = np.random.default_rng(seed * 7_777_777 + step)
        seeds = rng.integers(0, sampler.n, size=batch_nodes)
        return sampler.sample(seeds, fanouts, seed=seed * 13 + step,
                              n_pad=n_pad, e_pad=e_pad, d_feat=d_feat)

    return PrefetchingIterator(make, start_step=start_step,
                               prefetch=prefetch)
