"""The near-tie rule for comparing two greedy streams.

Two engines that run different kernels (or two frameworks) round
differently, so a greedy stream may flip where the two best logits are
nearly equal, and everything after the flip differs.  The rule the CPU
tests and ``chip_smoke.py`` hold: the first step at which two streams
differ must be one where the reference path's top-2 logit margin is
below ``NEAR_TIE``.  The margin is recomputed by teacher forcing, through
the reference engine's own prefill and decode steps on a private pool.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.serve.api import Request, RequestResult
from repro_torch.serve.paged_engine import PagedServeEngine

__all__ = ["NEAR_TIE", "teacher_forced_margins", "divergences"]

NEAR_TIE = 0.05


def _margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def teacher_forced_margins(engine: PagedServeEngine, prompt: np.ndarray,
                           tokens: Sequence[int]) -> np.ndarray:
    """Top-2 logit margin behind each token of a greedy stream: the
    prompt prefilled in the engine's chunks, then ``tokens`` fed back one
    decode step at a time, on a one-slot engine sharing ``engine``'s
    config, weights, page and chunk size."""
    solo = PagedServeEngine(engine.cfg, engine.params,
                            max_len=engine.max_len, max_batch=1,
                            page=engine.page,
                            prefill_chunk=engine.prefill_chunk,
                            device=engine.device)
    table = np.arange(1, solo.nb_table + 1, dtype=np.int32)[None]
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    s, C = prompt.shape[0], solo.prefill_chunk
    for pos in range(0, s, C):
        nv = min(C, s - pos)
        toks = np.zeros((1, C), np.int32)
        toks[0, :nv] = prompt[pos:pos + nv]
        logits = solo.prefill(toks, table, pos, nv)
    margins = [_margin(logits)]
    for t, tok in enumerate(list(tokens)[:-1]):
        logits = solo.decode(np.array([tok], np.int32), table,
                             np.array([s + t], np.int32))[0]
        margins.append(_margin(logits))
    return np.asarray(margins)


def divergences(reference: PagedServeEngine, requests: Sequence[Request],
                ref_results: Sequence[RequestResult],
                got_results: Sequence[RequestResult]) -> List[Dict]:
    """One record per request whose greedy stream differs from the
    reference's: the first differing step, the reference's top-2 margin
    there, and whether that is a near-tie (margin < ``NEAR_TIE``).
    Streams of different lengths are never a near-tie."""
    out = []
    for i, (req, a, b) in enumerate(zip(requests, ref_results, got_results)):
        if len(a.tokens) != len(b.tokens):
            out.append({"request": i, "step": None, "margin": None,
                        "near_tie": False})
            continue
        diff = np.flatnonzero(np.asarray(a.tokens) != np.asarray(b.tokens))
        if diff.size == 0:
            continue
        k = int(diff[0])
        m = float(teacher_forced_margins(reference, req.prompt,
                                         a.tokens[:k + 1])[k])
        out.append({"request": i, "step": k, "margin": m,
                    "near_tie": m < NEAR_TIE})
    return out
