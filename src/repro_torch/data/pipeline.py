"""Synthetic LM data pipeline (twin of ``repro.data.pipeline``).

``SyntheticLM`` generates a deterministic Zipf-distributed token stream
in which token t+1 follows token t through a fixed permutation, mixed
with noise, so a small model has signal to learn.  ``batch(step)`` is a
pure function of (seed, step), with the reference's numpy draws in the
reference's order: its batches are the reference's, bit for bit.  That
makes the fault-tolerant controller's replay after a restart exact.

``prefetch_to_device`` overlaps host generation with device compute: a
background thread fills a bounded queue with batches already moved to
the device (pinned and copied without blocking on a CUDA target) and,
given ``sharding``, laid out on a device mesh as DTensors, as the
reference places each batch with its ``NamedSharding``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.api import place

# (mesh, placements): one layout for every leaf
Layout = Tuple[object, Sequence]

__all__ = ["SyntheticLM", "prefetch_to_device"]


class SyntheticLM:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 seed: int = 0, correlation: float = 0.8):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.correlation = correlation
        rng = np.random.RandomState(seed)
        self._perm = rng.permutation(vocab_size)
        # Zipf-ish unigram distribution
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()

    def batch_np(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens", "labels"}``, (batch, seq_len) int32 each; the
        labels are the tokens shifted by one."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab_size, size=B, p=self._p)
        follow = rng.random((B, S)) < self.correlation
        fresh = rng.choice(self.vocab_size, size=(B, S), p=self._p)
        for t in range(S):
            nxt = self._perm[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        return self.batch_np(step)

    def iterate(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start
        while True:
            yield self.batch_np(step)
            step += 1


def prefetch_to_device(
        it: Iterator, *, size: int = 2,
        device: Union[str, torch.device, None] = "cuda",
        sharding: Union[None, Layout,
                        Callable[[str, torch.Tensor], Optional[Layout]]]
        = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield ``it``'s batches (dicts of numpy arrays) as tensors on
    ``device``, prepared by a background thread at most ``size`` batches
    ahead; the thread starts at once.  On a CUDA device each host array
    is pinned and copied with ``non_blocking=True``.  An exception in
    ``it`` is raised by the iterator, after the batches before it.

    ``sharding`` lays each leaf out on a mesh as a DTensor with
    :func:`repro_torch.parallel.api.place`: a ``(mesh, placements)``
    pair for every leaf, or a rule ``rule(name, tensor)`` giving each
    leaf's pair (None leaves that one a plain tensor).  Every rank draws
    the same full batch and keeps its own block, with no communication;
    ``device`` must be the mesh's (the rank's card on a CUDA mesh)."""
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            layout = sharding(k, t) if callable(sharding) else sharding
            out[k] = t if layout is None else place(t, *layout)
        return out

    def worker():
        try:
            for b in it:
                q.put(put(b))
        except Exception as e:      # handed to the consumer, raised there
            q.put(e)
        finally:
            q.put(end)

    def drain():
        while True:
            b = q.get()
            if b is end:
                return
            if isinstance(b, Exception):
                raise b
            yield b

    threading.Thread(target=worker, daemon=True).start()
    return drain()
