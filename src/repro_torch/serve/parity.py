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

An MoE model adds a second kind of tie.  A token whose k-th and
(k+1)-th router probabilities are nearly equal may pick another expert
under the other path's rounding, which moves its logits far more than
rounding does, so the streams may then part at any logit margin.  Given
the engine that produced the stream under test, :func:`divergences`
accepts such a divergence as a routing near-tie: teacher-forcing both
engines along the reference stream with their routing logged
(:func:`routing_log`), the first MoE call whose top-k sets differ (all
routing before it agreed, so it is the root) must differ only where the
reference path's top-k / top-(k+1) probability margin is below
``ROUTING_NEAR_TIE``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.api import Request, RequestResult

__all__ = ["NEAR_TIE", "ROUTING_NEAR_TIE", "TeacherForcing",
           "teacher_forced_margins", "routing_log", "routing_differences",
           "divergences"]

NEAR_TIE = 0.05
ROUTING_NEAR_TIE = 1e-3


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


@contextlib.contextmanager
def routing_log() -> Iterator[List[torch.Tensor]]:
    """Record the router's softmax probabilities, (G, S, E) f32, of every
    MoE layer call the port makes inside the block, in call order (the
    router is run once more on the same inputs, so nothing it returns
    changes)."""
    from repro_torch.models import moe
    calls: List[torch.Tensor] = []
    router_topk = moe.router_topk

    def logged(cfg, w_router, x):
        calls.append(torch.softmax(
            torch.matmul(x.float(), w_router.float()), dim=-1))
        return router_topk(cfg, w_router, x)

    moe.router_topk = logged
    try:
        yield calls
    finally:
        moe.router_topk = router_topk


def routing_differences(top_k: int, calls: Sequence[torch.Tensor],
                        ref_calls: Sequence[torch.Tensor]
                        ) -> List[Tuple[int, List[Tuple[int, float]]]]:
    """For each MoE call whose top-k expert sets differ on some rows
    (tokens), ``(call, [(row, margin), ...])`` with the reference's
    top-k / top-(k+1) probability margin of each such row.  The two logs
    must come from the same sequence of calls."""
    if len(calls) != len(ref_calls):
        raise ValueError(f"routing logs of {len(calls)} and "
                         f"{len(ref_calls)} MoE calls do not pair up")
    out = []
    for c, (p, q) in enumerate(zip(calls, ref_calls)):
        p, q = p.reshape(-1, p.shape[-1]), q.reshape(-1, q.shape[-1])
        sp = torch.sort(p, dim=-1, descending=True, stable=True)
        sq = torch.sort(q, dim=-1, descending=True, stable=True)
        differ = (sp.indices[:, :top_k].sort(dim=-1).values
                  != sq.indices[:, :top_k].sort(dim=-1).values).any(-1)
        rows = torch.nonzero(differ).flatten().tolist()
        if rows:
            margin = sq.values[:, top_k - 1] - sq.values[:, top_k]
            out.append((c, [(r, float(margin[r])) for r in rows]))
    return out


def _routing_root(reference, engine, prompt, tokens) -> Optional[Dict]:
    """The first routing difference between ``engine`` and ``reference``
    teacher-forced along ``tokens``: its MoE call, rows and largest
    reference margin; None when they route alike all the way."""
    logs = []
    for eng in (engine, reference):
        with routing_log() as log:
            eng.teacher_forced_logits(prompt, tokens)
        logs.append(log)
    diffs = routing_differences(engine.cfg.moe.top_k, *logs)
    if not diffs:
        return None
    call, rows = diffs[0]
    return {"call": call, "rows": len(rows),
            "margin": max(m for _, m in rows)}


def divergences(reference: TeacherForcing, requests: Sequence[Request],
                ref_results: Sequence[RequestResult],
                got_results: Sequence[RequestResult], *,
                engine=None,
                routing_margin: float = ROUTING_NEAR_TIE) -> List[Dict]:
    """One record per request whose greedy stream differs from the
    reference's: the first differing step, the reference's top-2 margin
    there, and whether that is a near-tie (margin < ``NEAR_TIE``).
    Streams of different lengths are never a near-tie.

    With ``engine``, the port's engine that produced ``got_results`` on
    an MoE model, a divergence above ``NEAR_TIE`` is also a near-tie when
    it is a routing near-tie (module docstring, margins below
    ``routing_margin``); its record then carries ``"routing"``: the
    first differing MoE call, its number of differing rows and their
    largest reference margin (None when routing agreed throughout)."""
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
        rec = {"request": i, "step": k, "margin": m,
               "near_tie": m < NEAR_TIE}
        if not rec["near_tie"] and engine is not None \
                and engine.cfg.moe is not None:
            root = _routing_root(reference, engine, req.prompt,
                                 a.tokens[:k + 1])
            rec["routing"] = root
            rec["near_tie"] = root is not None \
                and root["margin"] < routing_margin
        out.append(rec)
    return out
