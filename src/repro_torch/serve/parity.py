"""The exactly arbitrated near-tie rule for comparing greedy streams.

Two engines that run different kernels (or two frameworks) round
differently, so a greedy stream may flip where the two best logits are
nearly equal, and everything after the flip differs.  Which of the two
tokens is right is a question for a more exact computation, so the rule
asks the **exact run**: the plain path one type up from the working
type (``EXACT``: float32 for bf16, float64 for float32), the same
weights upcast (:func:`float32_params`, one layer at a time as the
model reads it; for float64 under :func:`float64_mode`), the same prompt
(:func:`exact_engine`), and on an MoE model the reference's routing
(``routing_log(follow=...)``): the compared paths share their routing
upstream of where they part, so the exact run takes it too, and its
logits and router margins differ from the reference's by rounding
alone.

* **Streams.**  A tested stream (kernel path, other engine, or the
  port's engine against the reference's) first differs from the
  reference stream at step k: tested token a, reference token b.  The
  exact run, teacher-forced along the common prefix, gives logits l at
  step k.  The divergence is accepted only where the exact run picks a,
  or where ``max(l) - l[a] < TAU_LOGIT``: the tested token is the exact
  computation's choice or a near-tie in it.  Streams of different
  lengths are never accepted.
* **Routing (MoE).**  A token whose k-th and (k+1)-th router
  probabilities nearly tie may pick another expert under the other
  path's rounding, which moves its logits far more than rounding does,
  so the streams may then part at any logit margin.  Given the engine
  that produced the tested stream, a divergence the stream rule refuses
  is accepted at a routing near-tie: teacher-forcing the tested engine,
  the reference and the exact run along the stream with their routing
  logged (:func:`routing_log`), at the first MoE call whose top-k sets
  differ between the tested path and the reference (all routing before
  it agreed, so it is the root), every differing row's tested top-k set
  equals the exact run's, or the exact run's top-k / top-(k+1)
  probability margin there is below ``TAU_ROUTE``.  A top-k margin is
  at most 1/k, so a TAU_ROUTE at or above it could refuse nothing:
  :func:`tau_route` raises for it.

Any engine of the port serves as the reference, as long as it has
``teacher_forced_logits(prompt, tokens)`` (the sync
:class:`~repro_torch.serve.ServeEngine` and the paged
:class:`~repro_torch.serve.PagedServeEngine` both do, and
:func:`exact_engine` builds either's exact twin; another engine gives a
``twin(cfg, params)``).

**Calibration** (``scripts/torch_near_tie_calibration.py``).  The two
tau come from the plain path against its exact run only; no kernel
enters them.  Along the plain stream of each parity trace both are
teacher-forced, the exact run routed as the plain path; at each
position, the shift that rounding gives the margin between the plain
path's top token and every token within ``LOGIT_WINDOW`` of it
(:func:`logit_noise`), and at each routed row the shift of the
probability margin between every expert of the plain top-k and every
other expert within ``ROUTE_WINDOW`` of it in router logit
(:func:`routing_noise`).  Each tau is twice the largest shift seen over
three seeds of every trace (the workload's own, and its weight and
trace seeds + 1000 and + 2000), since both compared paths carry that
noise.  ``READINGS`` holds the largest shifts by working type, by scale
(``"full"``: the catalog's widths, measured on the card; ``"reduced"``:
``cfg.reduced()``, measured on the CPU) and by family (dense GQA, MoE,
SSM/hybrid, MLA+MoE: one entry a family, since their readings differ by
more than 2x):

* bf16, full widths (NVIDIA H100 80GB HBM3, 700.00 W; the plain streams
  of ``chip_smoke.py`` phases 3, 4, 8, 9, 14, 16, 17, 18 and 19 at their
  models, cuts and seeds): logits dense 0.0621 (qwen2-7b, internlm2,
  mistral-nemo, yi, vision and whisper at 0-0.0621), MoE 0.02934
  (qwen3-moe), SSM/hybrid 0.1447 (jamba), MLA+MoE 0.1679 (deepseek);
  routing MoE 0.001015, SSM/hybrid 0.03434, MLA+MoE 0.01336.  By seed
  (own, + 1000, + 2000) they spread: dense 0.0572-0.0621, MoE
  0.0213-0.0293 / 0.00087-0.00101, SSM/hybrid 0.0953-0.1447 /
  0.0286-0.0343, MLA+MoE 0.1157-0.1679 / 0.0120-0.0134.
* bf16, reduced (CPU; the ``base`` trace through the sync engine and the
  ``shared_prefix`` trace through the paged engine, weights from a
  seed): logits dense 0.06351, MoE 0.04465, SSM/hybrid 0.1568 (mamba2;
  jamba 0.1313), MLA+MoE 0.06221; routing MoE 0.01314, SSM/hybrid
  0.04142, MLA+MoE 0.01693.
* float32, full widths (the same card; mamba2-370m's float32 streams of
  phase 12, the weights drawn in bf16 and upcast): logits SSM 0.002784
  (0.00086-0.00278 by seed); no other model is held in float32 at full
  width, so no other family has a reading there.
* float32, reduced (CPU, the traces above): logits dense 5.915e-06, MoE
  4.631e-06, SSM/hybrid 2.126e-05, MLA+MoE 7.192e-06; routing MoE
  1.201e-06, SSM/hybrid 2.858e-06, MLA+MoE 1.265e-06.

:func:`taus` doubles them; a working type, scale or family with no
reading raises rather than borrow another's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (Callable, Dict, Iterator, List, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.serve.api import Request, RequestResult
from repro_torch.tree import tree_map

__all__ = ["LOGIT_WINDOW", "ROUTE_WINDOW", "EXACT", "READINGS",
           "TeacherForcing", "taus", "tau_route", "family", "float64_mode",
           "float32_config", "float32_params", "exact_run", "exact_engine",
           "logit_noise", "routing_noise", "noise_readings", "routing_log",
           "routing_differences", "routing_verdicts", "stream_verdict",
           "divergences", "describe"]

LOGIT_WINDOW = 0.1
ROUTE_WINDOW = 0.1
# the exact run's type for each working type
EXACT = {"bfloat16": "float32", "float32": "float64"}
# the largest shifts of a working type against its exact run, (logit,
# routing), by working type, scale and family ("all": every family the
# scale has no entry of its own for); scripts/torch_near_tie_calibration.py
# measures them
READINGS: Dict[str, Dict[str, Dict[str, Tuple[float, Optional[float]]]]] = {
    "bfloat16": {
        "full": {"dense": (0.0621, None), "moe": (0.02934, 0.001015),
                 "ssm": (0.1447, 0.03434), "mla_moe": (0.1679, 0.01336)},
        "reduced": {"dense": (0.06351, None), "moe": (0.04465, 0.01314),
                    "ssm": (0.1568, 0.04142), "mla_moe": (0.06221, 0.01693)},
    },
    "float32": {
        "full": {"ssm": (0.002784, None)},
        "reduced": {"dense": (5.915e-06, None), "moe": (4.631e-06, 1.201e-06),
                    "ssm": (2.126e-05, 2.858e-06),
                    "mla_moe": (7.192e-06, 1.265e-06)},
    },
}


class TeacherForcing(Protocol):
    def teacher_forced_logits(self, prompt: np.ndarray,
                              tokens: Sequence[int]) -> List[torch.Tensor]:
        """The (V,) logits behind each of ``tokens``: the prompt's, then
        those of each token fed back in turn."""


def family(cfg) -> str:
    """The noise family of a config: ``"mla_moe"``, ``"ssm"`` (SSM or
    hybrid), ``"moe"`` or ``"dense"``."""
    if cfg.mla is not None and cfg.moe is not None:
        return "mla_moe"
    if cfg.ssm is not None:
        return "ssm"
    return "moe" if cfg.moe is not None else "dense"


def _reading(cfg) -> Tuple[float, Optional[float]]:
    scale = "reduced" if cfg.name.endswith("-smoke") else "full"
    entries = READINGS.get(cfg.dtype, {}).get(scale, {})
    got = entries.get(family(cfg), entries.get("all"))
    if got is None:
        raise ValueError(
            f"no near-tie reading for {cfg.name} in {cfg.dtype} ({scale} "
            f"scale, family {family(cfg)}): measure it with "
            f"scripts/torch_near_tie_calibration.py")
    return got


def taus(cfg) -> Tuple[float, Optional[float]]:
    """(TAU_LOGIT, TAU_ROUTE) for ``cfg``: twice the largest shift in
    ``READINGS`` at its working type, scale (``"reduced"`` for a
    ``cfg.reduced()``, whose name ends in ``-smoke``) and family.
    TAU_ROUTE is None where no routing was measured.  Raises
    ``ValueError`` where nothing was measured."""
    logit, route = _reading(cfg)
    return 2 * logit, None if route is None else 2 * route


def tau_route(cfg) -> float:
    """TAU_ROUTE for judging ``cfg``'s routing.  A top-k / top-(k+1)
    probability margin is at most 1/k, so a tau at or above it would
    accept every routing difference: such a reading (or none) raises
    ``ValueError``, and the model's routing is held in a working type
    whose noise the rule can resolve."""
    _, tau = taus(cfg)
    if tau is None or tau >= 1 / cfg.moe.top_k:
        raise ValueError(
            f"{cfg.name} in {cfg.dtype}: routing tau {tau} cannot refuse "
            f"a routing difference (a top-{cfg.moe.top_k} margin is at "
            f"most {1 / cfg.moe.top_k:.4g}); measure its routing noise, "
            f"or hold its routing in a type whose noise the rule resolves")
    return tau


# -- the exact run ------------------------------------------------------------

class float64_mode(TorchFunctionMode):
    """Every float32 operation inside computes in float64: float32
    operands are upcast, float32 dtype arguments (and ``.float()``) mean
    float64.  An in-place op keeps its target's type, so tensors an op
    writes into are made inside the mode.  The exact run of a float32
    working type is its plain path under this mode (the model code
    names float32 as its accumulation type throughout)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.float:
            return args[0].double()

        def up(x):
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                return x.double()
            if x is torch.float32:
                return torch.float64
            if isinstance(x, (list, tuple)):
                return type(x)(up(v) for v in x)
            if isinstance(x, dict):
                return {k: up(v) for k, v in x.items()}
            return x

        name = getattr(func, "__name__", "")
        inplace = name.endswith("_") or name == "__setitem__"
        args = (args[:1] if inplace else ()) + tuple(
            up(a) for a in args[1 if inplace else 0:])
        return func(*args, **up(kwargs))


def _f32(t):
    return t.float() if isinstance(t, torch.Tensor) \
        and t.is_floating_point() else t


def float32_config(cfg):
    """``cfg``'s plain path in float32."""
    return dataclasses.replace(cfg, dtype="float32", use_kernels=False)


class _Float32Layers(list):
    """The layer list of :func:`float32_params`: holds the working-type
    layers and gives each one upcast when the model reads it, so the
    float32 copy of a layer lives only while the layer runs."""

    def __iter__(self):
        for layer in list.__iter__(self):
            yield tree_map(_f32, layer)

    def __getitem__(self, i):
        return tree_map(_f32, list.__getitem__(self, i))


def float32_params(params) -> Dict:
    """``params`` as the float32 run reads them: every leaf outside the
    layers upcast now, each layer upcast when the model reaches it (a
    float32 copy of the whole model never sits beside the working one;
    the model code is unchanged).  Under :func:`float64_mode` the upcast
    is to float64."""
    out = {k: tree_map(_f32, v) for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    out["layers"] = _Float32Layers(list.__iter__(layers)
                                   if isinstance(layers, _Float32Layers)
                                   else layers)
    return out


def exact_run(cfg, params) -> Tuple[object, Dict, Callable]:
    """The exact run of ``cfg``: (config, weights, context) with which
    to run its plain path one type up (``EXACT``): for bf16 the plain
    path in float32 with the weights upcast a layer at a time, for
    float32 the same under :func:`float64_mode` (``context()`` enters
    it; a null context for bf16)."""
    up = EXACT[cfg.dtype]
    ctx = float64_mode if up == "float64" else contextlib.nullcontext
    return float32_config(cfg), float32_params(params), ctx


class _Exact:
    """A port engine's exact twin: teacher forcing under the exact run's
    context (:func:`exact_engine`)."""

    def __init__(self, twin, ctx):
        self.twin, self.ctx, self.cfg = twin, ctx, twin.cfg

    def teacher_forced_logits(self, prompt, tokens):
        with self.ctx():
            return self.twin.teacher_forced_logits(prompt, tokens)


def exact_engine(engine) -> _Exact:
    """The exact run of a port engine (:func:`exact_run`), one slot, the
    same class, max_len, page and chunk: the arbiter of
    :func:`divergences`.  Another teacher-forcing engine takes part by a
    ``twin(cfg, params)`` method building itself on other weights."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.paged_engine import PagedServeEngine
    cfg, params, ctx = exact_run(engine.cfg, engine.params)
    with ctx():
        if isinstance(engine, PagedServeEngine):
            twin = PagedServeEngine(cfg, params, max_len=engine.max_len,
                                    max_batch=1, page=engine.page,
                                    prefill_chunk=engine.prefill_chunk,
                                    device=engine.device)
        elif isinstance(engine, ServeEngine):
            twin = ServeEngine(cfg, params, max_len=engine.max_len,
                               prefill_pad=engine.prefill_pad,
                               device=engine.device)
        elif hasattr(engine, "twin"):
            twin = engine.twin(cfg, params)
        else:
            raise TypeError(f"no exact twin of a {type(engine).__name__}; "
                            f"give it twin(cfg, params) or pass exact=")
    return _Exact(twin, ctx)


# -- noise: how far rounding moves a margin ----------------------------------

def logit_noise(logits: torch.Tensor, exact: torch.Tensor,
                window: float = LOGIT_WINDOW) -> float:
    """The largest shift, from ``logits`` to the exact run's, of the
    margin between ``logits``' top token and each other token within
    ``window`` of it (0.0 when none is)."""
    p = logits.double().flatten()
    f = exact.double().flatten().to(p.device)
    top = int(p.argmax())
    near = p[top] - p < window
    near[top] = False
    if not bool(near.any()):
        return 0.0
    return float(((p[top] - p[near]) - (f[top] - f[near])).abs().max())


def routing_noise(top_k: int, calls: Sequence[torch.Tensor],
                  exact_calls: Sequence[torch.Tensor],
                  window: float = ROUTE_WINDOW) -> float:
    """The largest shift, from the router probabilities of ``calls`` to
    the exact run's, of the margin between each expert of a row's top-k
    and each other expert within ``window`` of it in router logit
    (log-probability)."""
    worst = 0.0
    for p, f in zip(calls, exact_calls):
        p = p.reshape(-1, p.shape[-1]).double()
        f = f.reshape(-1, f.shape[-1]).double().to(p.device)
        order = torch.sort(p, dim=-1, descending=True, stable=True).indices
        inside, outside = order[:, :top_k], order[:, top_k:]
        pi, pj = p.gather(1, inside)[:, :, None], p.gather(1, outside)[:, None]
        fi, fj = f.gather(1, inside)[:, :, None], f.gather(1, outside)[:, None]
        near = torch.log(pi) - torch.log(pj) < window
        if bool(near.any()):
            worst = max(worst, float(((pi - pj) - (fi - fj)).abs()[near].max()))
    return worst


def _forced(engine, prompt, tokens, logged: bool, follow=None):
    """Teacher-forced logits of ``engine`` along ``tokens``, and its
    routing log when ``logged`` (else None); routed as ``follow`` (a
    routing log of the same calls) when given."""
    if not logged:
        return engine.teacher_forced_logits(prompt, tokens), None
    with routing_log(follow) as calls:
        logits = engine.teacher_forced_logits(prompt, tokens)
    return logits, calls


def noise_readings(plain: TeacherForcing, exact: TeacherForcing,
                   requests: Sequence[Request],
                   results: Sequence[RequestResult], *,
                   top_k: Optional[int] = None) -> Dict:
    """The calibration's measurement on one trace: ``plain`` and its
    exact run teacher-forced along ``plain``'s own streams
    (``results``), the exact run routed as ``plain`` routes (so its
    logits and router margins differ from the plain path's by rounding
    alone, not by a routing choice upstream); the largest
    :func:`logit_noise` over every position and, with the MoE
    ``top_k``, the largest :func:`routing_noise` over every routed
    row."""
    out = {"logit": 0.0, "route": None if top_k is None else 0.0,
           "positions": 0}
    for req, res in zip(requests, results):
        p_l, p_calls = _forced(plain, req.prompt, res.tokens, top_k is not None)
        f_l, f_calls = _forced(exact, req.prompt, res.tokens,
                               top_k is not None, follow=p_calls)
        out["positions"] += len(p_l)
        out["logit"] = max([out["logit"]] + [logit_noise(a, b)
                                             for a, b in zip(p_l, f_l)])
        if top_k is not None:
            out["route"] = max(out["route"],
                               routing_noise(top_k, p_calls, f_calls))
    return out


# -- routing ----------------------------------------------------------------

def _top_k(p: torch.Tensor, k: int) -> torch.Tensor:
    """The top-k experts of router probabilities ``p`` as ``router_topk``
    orders them (a stable descending sort: ties to the lower index)."""
    return torch.sort(p, dim=-1, descending=True, stable=True).indices[..., :k]


@contextlib.contextmanager
def routing_log(follow: Optional[Sequence[torch.Tensor]] = None
                ) -> Iterator[List[torch.Tensor]]:
    """Record the router's softmax probabilities, (G, S, E), of every MoE
    layer call the port makes inside the block, in call order (the
    router is run once more on the same inputs, so nothing it returns
    changes).  With ``follow``, the routing log of a run of the same
    calls, each call takes ``follow``'s top-k experts (its gates are its
    own probabilities there, renormalised): the run is routed as that
    one, and its log still holds its own probabilities."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    calls: List[torch.Tensor] = []
    router_topk = moe.router_topk

    def logged(cfg, w_router, x):
        probs = torch.softmax(torch.matmul(x.float(), w_router.float()),
                              dim=-1)
        calls.append(probs)
        if follow is None:
            return router_topk(cfg, w_router, x)
        m = cfg.moe
        want = follow[len(calls) - 1]
        if want.shape != probs.shape:
            raise ValueError(f"MoE call {len(calls) - 1}: router "
                             f"probabilities {tuple(probs.shape)} cannot "
                             f"follow a log of {tuple(want.shape)}")
        idx = _top_k(want, m.top_k).to(probs.device)
        gates = probs.gather(-1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        me = probs.mean(dim=(0, 1))
        ce = F.one_hot(idx, m.n_experts).to(probs.dtype).mean(dim=(0, 1, 2))
        return gates, idx, m.n_experts * torch.sum(me * ce)

    moe.router_topk = logged
    try:
        yield calls
    finally:
        moe.router_topk = router_topk


def _sorted(p: torch.Tensor, top_k: int):
    """(top-k sets sorted by expert, top-k / top-(k+1) margins) by row."""
    p = p.reshape(-1, p.shape[-1])
    s = torch.sort(p, dim=-1, descending=True, stable=True)
    return (s.indices[:, :top_k].sort(dim=-1).values,
            s.values[:, top_k - 1] - s.values[:, top_k])


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
        sp, _ = _sorted(p, top_k)
        sq, margin = _sorted(q, top_k)
        rows = torch.nonzero((sp != sq.to(sp.device)).any(-1)).flatten()
        if len(rows):
            out.append((c, [(r, float(margin[r])) for r in rows.tolist()]))
    return out


def routing_verdicts(top_k: int, calls: Sequence[torch.Tensor],
                     ref_calls: Sequence[torch.Tensor],
                     exact_calls: Sequence[torch.Tensor], tau: float, *,
                     first_call_only: bool = False) -> Dict[int, Dict]:
    """Each row whose routing differs between ``calls`` (the tested
    path) and ``ref_calls``, judged at the first call where it differs
    (its root: the rows of one decode step are independent tokens)
    against the exact run routed as the reference
    (``routing_log(follow=ref_calls)``, so its router sees the inputs
    the reference's routing gives, up to rounding):
    ``{row: {"call", "ref_margin", "exact_margin", "as_exact",
    "accepted"}}`` with ``as_exact`` whether the tested top-k set is the
    exact run's, and ``accepted`` that or an exact margin below ``tau``.
    With ``first_call_only`` only the rows of the first differing call
    (the root of a stream, whose rows are one request's positions)."""
    if len(exact_calls) != len(calls):
        raise ValueError(f"the exact run's routing log has "
                         f"{len(exact_calls)} MoE calls, the tested "
                         f"path's {len(calls)}")
    out: Dict[int, Dict] = {}
    for call, rows in routing_differences(top_k, calls, ref_calls):
        got, _ = _sorted(calls[call], top_k)
        want, margin = _sorted(exact_calls[call], top_k)
        for r, m in rows:
            if r in out:
                continue
            as_exact = bool((got[r] == want[r].to(got.device)).all())
            em = float(margin[r])
            out[r] = {"call": call, "ref_margin": m, "exact_margin": em,
                      "as_exact": as_exact, "accepted": as_exact or em < tau}
        if first_call_only:
            break
    return out


# -- streams -------------------------------------------------------------------

def _margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits.double(), 2).values
    return float(top[0] - top[1])


def stream_verdict(ref_logits: torch.Tensor, exact_logits: torch.Tensor,
                   token: int, ref_token: int, tau: float) -> Dict:
    """One first divergence judged: the tested ``token`` against the
    reference's ``ref_token``, with the reference's and the exact run's
    logits at that step."""
    f = exact_logits.double().flatten()
    exact_token = int(f.argmax())
    return {"token": int(token), "ref_token": int(ref_token),
            "margin": _margin(ref_logits), "exact_token": exact_token,
            "exact_gap": float(f.max() - f[token]), "tau": tau,
            "accepted": exact_token == int(token)
            or float(f.max() - f[token]) < tau}


def divergences(reference: TeacherForcing, requests: Sequence[Request],
                ref_results: Sequence[RequestResult],
                got_results: Sequence[RequestResult], *,
                engine=None, exact: Optional[TeacherForcing] = None
                ) -> List[Dict]:
    """One record per request whose greedy stream in ``got_results``
    differs from the reference's, judged by the module's rule:
    ``request``, ``step``, the tested ``token`` and ``ref_token``, the
    reference's top-2 ``margin`` there, the exact run's type
    (``exact``: float32 for a bf16 reference, float64 for a float32
    one), its ``exact_token`` and the tested token's ``exact_gap`` below
    its top, ``tau``, the largest :func:`logit_noise` between the
    reference and the exact run along the common prefix (``noise``, this
    run's reading), and ``accepted``.  On an MoE model the exact run is
    routed as the reference (``routing_log(follow=...)``), so its logits
    judge rounding, not a routing choice the two compared paths share.
    ``exact`` (the exact run) defaults to :func:`exact_engine` of
    ``reference``, built at the first divergence.

    With ``engine``, the port's engine that produced ``got_results`` on
    an MoE model, a divergence the stream rule refuses is judged at its
    routing root, recorded under ``"routing"`` (None when routing agreed
    throughout): the root's ``call``, each differing row's verdict
    (:func:`routing_verdicts`), ``tau`` (:func:`tau_route`, which raises
    where the working type's routing noise leaves the rule nothing to
    refuse) and this run's :func:`routing_noise` between the reference
    and the exact run."""
    cfg = reference.cfg
    tau_logit, _ = taus(cfg)
    routed = cfg.moe is not None
    judge_routing = engine is not None and routed
    tau_r = tau_route(cfg) if judge_routing else None
    out = []
    for i, (req, a, b) in enumerate(zip(requests, ref_results, got_results)):
        if len(a.tokens) != len(b.tokens):
            out.append({"request": i, "step": None, "accepted": False})
            continue
        diff = np.flatnonzero(np.asarray(a.tokens) != np.asarray(b.tokens))
        if diff.size == 0:
            continue
        k = int(diff[0])
        tokens = a.tokens[:k + 1]
        if exact is None:
            exact = exact_engine(reference)
        ref_l, ref_calls = _forced(reference, req.prompt, tokens, routed)
        f_l, f_calls = _forced(exact, req.prompt, tokens, routed,
                               follow=ref_calls)
        rec = {"request": i, "step": k, "exact": EXACT[cfg.dtype]}
        rec.update(stream_verdict(ref_l[k], f_l[k], int(b.tokens[k]),
                                  int(a.tokens[k]), tau_logit))
        rec["noise"] = max(logit_noise(r, f) for r, f in zip(ref_l, f_l))
        if not rec["accepted"] and judge_routing:
            with routing_log() as calls:
                engine.teacher_forced_logits(req.prompt, tokens)
            rows = routing_verdicts(cfg.moe.top_k, calls, ref_calls,
                                    f_calls, tau_r, first_call_only=True)
            rec["routing"] = None if not rows else {
                "call": next(iter(rows.values()))["call"], "rows": rows,
                "tau": tau_r,
                "noise": routing_noise(cfg.moe.top_k, ref_calls, f_calls)}
            rec["accepted"] = bool(rows) and all(
                r["accepted"] for r in rows.values())
        out.append(rec)
    return out


def describe(d: Dict, what: str = "tested and reference paths") -> str:
    """One line for a divergence record of :func:`divergences`."""
    if d["step"] is None:
        return f"request {d['request']}: {what}: streams of different lengths"
    x = d.get("exact", "float32")
    line = (f"request {d['request']}: {what} diverge at step {d['step']}: "
            f"token {d['token']} against {d['ref_token']}, reference top-2 "
            f"margin {d['margin']:.4g}; {x} picks {d['exact_token']}, "
            f"token {d['token']} {d['exact_gap']:.4g} below its top (tau "
            f"{d['tau']:.4g}; {x} noise along the prefix this run "
            f"{d['noise']:.4g})")
    if "routing" in d:
        r = d["routing"]
        if r is None:
            line += "; routing agrees throughout"
        else:
            rows = ", ".join(
                f"row {row}: reference margin {v['ref_margin']:.3g}, {x} "
                f"margin {v['exact_margin']:.3g}, "
                f"{'as' if v['as_exact'] else 'unlike'} {x}"
                for row, v in sorted(r["rows"].items()))
            line += (f"; routing root at MoE call {r['call']} ({rows}; tau "
                     f"{r['tau']:.3g}; {x} routing noise this run "
                     f"{r['noise']:.3g})")
    return line + (": accepted" if d["accepted"] else ": REFUSED")
