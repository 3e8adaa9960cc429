"""The near-tie rule for comparing two greedy streams.

Two engines that run different kernels (or two frameworks) round
differently, so a greedy stream may flip where the two best logits are
nearly equal, and everything after the flip differs.  The rule the CPU
tests and ``chip_smoke.py`` hold: the first step at which two streams
differ must be one where the reference path's top-2 logit margin is
below ``NEAR_TIE``.  The margin is recomputed by teacher forcing through
the reference engine's own steps: any engine of the port serves, as long
as it has ``teacher_forced_logits(prompt, tokens)`` (the sync
:class:`~repro_torch.serve.ServeEngine` and the paged
:class:`~repro_torch.serve.PagedServeEngine` both do).
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Sequence

import numpy as np
import torch

from repro_torch.serve.api import Request, RequestResult

__all__ = ["NEAR_TIE", "TeacherForcing", "teacher_forced_margins",
           "divergences"]

NEAR_TIE = 0.05


class TeacherForcing(Protocol):
    def teacher_forced_logits(self, prompt: np.ndarray,
                              tokens: Sequence[int]) -> List[torch.Tensor]:
        """The (V,) logits behind each of ``tokens``: the prompt's, then
        those of each token fed back in turn."""


def _margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def teacher_forced_margins(engine: TeacherForcing, prompt: np.ndarray,
                           tokens: Sequence[int]) -> np.ndarray:
    """Top-2 logit margin behind each token of a greedy stream."""
    return np.asarray([_margin(l) for l in
                       engine.teacher_forced_logits(prompt, tokens)])


def divergences(reference: TeacherForcing, requests: Sequence[Request],
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
