"""Deterministic, restart-exact data pipeline.

Port of the reference's ``data/pipeline.py`` (the batches are numpy, so
this is a copy of it).  Batches are a pure function of (seed, step):
after a failure or a restart the pipeline resumes from the checkpointed
step with bit-identical batches, a prerequisite for exactly-resumable
training.  Two sources:

  * ``SyntheticLM`` — hashed token streams;
  * ``CorpusLM``    — a memory-mapped token file, sampled with a
    step-deterministic RNG (the real-data path).

``host_slice`` takes one process's rows of the global batch; a background
thread prefetches (``prefetch``).  ``shard_batch`` moves a host batch to
one device: the reference's placement under a sharding waits for
``sharding/rules.py`` (ROADMAP, the tail).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None


class SyntheticLM:
    """tokens[b, t] drawn from (seed, step): cheap and exact."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, host_slice: slice = slice(None)) -> dict:
        cfg = self.cfg
        rows = range(*host_slice.indices(cfg.global_batch))
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        toks = rng.integers(0, cfg.vocab,
                            (cfg.global_batch, cfg.seq_len + 1), np.int32)
        toks = toks[list(rows)]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class CorpusLM:
    """Memory-mapped token corpus with deterministic step-indexed sampling."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.load(cfg.corpus_path, mmap_mode="r")
        if self.data.ndim != 1:
            raise ValueError(f"{cfg.corpus_path}: a corpus is one token "
                             f"stream, got shape {self.data.shape}")

    def batch(self, step: int, host_slice: slice = slice(None)) -> dict:
        cfg = self.cfg
        n = len(self.data) - cfg.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        starts = rng.integers(0, n, (cfg.global_batch,))
        rows = range(*host_slice.indices(cfg.global_batch))
        toks = np.stack([self.data[s:s + cfg.seq_len + 1]
                         for s in starts[list(rows)]]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_source(cfg: DataConfig):
    return CorpusLM(cfg) if cfg.corpus_path else SyntheticLM(cfg)


def prefetch(source, start_step: int, host_slice: slice = slice(None),
             depth: int = 2) -> Iterator[tuple[int, dict]]:
    """Background-thread prefetch of (step, batch) pairs."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, source.batch(step, host_slice)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


def shard_batch(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device`` (one
    device: no sharding until ``sharding/rules.py`` is ported)."""
    return {k: (v if torch.is_tensor(v)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}
