"""Per-device serving capacity: perf-engine cost -> queueing model -> QPS
(twin of ``repro.fleet.capacity``).

Three layers, each testable on its own:

1. **Cost graphs** — :func:`analytic_graphs` builds two synthetic
   :class:`~repro_torch.perf.hlo_ir.KernelGraph` modules per scenario
   from the FULL catalog :class:`ModelConfig` (no model, no capture):
   one *decode tick* (``max_batch`` slots advance one token through
   every layer at the scenario's mean context) and one *prefill chunk*
   (``prefill_chunk`` prompt tokens through every layer).  Dots carry
   real B/M/N/K so the MFMA/MXU engines can cost them; weight + KV-cache
   streaming is a ``memory`` op; ``tp > 1`` shards the per-layer dims
   and adds the tensor-parallel all-reduces as ``collective`` ops (an
   accounting in the graph: nothing runs on a second device).
   :func:`torch_graphs` is the opt-in captured alternative: the port's
   plain-path ``decode_step`` and ``prefill`` on the *reduced* config,
   recorded by :func:`repro_torch.perf.torch_graph.capture` on the meta
   device, where the reference compiles and parses XLA text.

2. **ServeCost** — :func:`serve_cost` runs both graphs through
   ``repro_torch.perf.predict`` on a device (optionally under an
   overlay) and records the two primitive times the scheduler is made
   of: ``decode_tick_s`` (whole batch, one token each) and
   ``prefill_chunk_s`` (one chunk of one prompt), plus what bounds each.
   Only the roofline prices ``h100`` (it has no cycle table): the
   ``mfma`` and ``scoreboard`` engines raise ``ValueError`` there.

3. **Queueing model** — closed-form and *strictly monotonic in QPS* by
   construction, so :func:`max_sustainable_qps` can bisect.  With
   per-device rate :math:`q`, mean prompt cost :math:`P` (chunks x
   chunk time), mean decode cost per request :math:`D = \\bar n \\cdot
   t_{tick} / B`:

   * server utilisation  :math:`\\rho = q (P + D)`; the prefill share
     :math:`\\phi = q P < \\rho`;
   * a decode token waits for the interleaved prefill chunks:
     token latency :math:`= t_{tick} / (1 - \\phi)`;
   * bursts queue requests: :math:`p99 = ` token latency
     :math:`\\times (1 + burstiness \\cdot \\rho / (1 - \\rho))`;
   * TTFT :math:`= P \\cdot (1 + burstiness \\cdot \\rho / (1-\\rho))`.

   :math:`\\rho \\ge 1` is overload (infinite latency).  The shape —
   service time stretched by interference, queueing growth
   :math:`\\rho/(1-\\rho)` — is the standard M/G/1-flavoured model; the
   *constants* come from the perf engines, not from hand-waving.

Calibration: :func:`simulate_trace` is a deterministic host-side
replica of the ``PagedServeEngine`` scheduler (same tick structure:
retire -> admit -> one prefill chunk per prefilling slot -> one decode
step for all actives) whose tick/step/chunk counts match the real
engine *exactly* on any trace; :func:`fit_tick_costs` turns measured
walls into per-primitive costs so predicted and measured per-token
latency can be compared within a tolerance band.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.arch.overlay import Overlay
from repro_torch.configs import get_config
from repro_torch.fleet.scenario import SLO, TrafficScenario
from repro_torch.models.config import ModelConfig
from repro_torch.perf.hlo_ir import BYTES_PER_ELEM, KernelGraph, KernelOp
from repro_torch.perf.pipeline import predict
from repro_torch.perf.report import Report
from repro_torch.serve.api import Request, as_requests

__all__ = ["analytic_graphs", "torch_graphs", "ServeCost", "serve_cost",
           "request_work_s", "token_latency_s", "ttft_s", "p99_latency_s",
           "max_sustainable_qps", "SimStats", "simulate_trace",
           "TickCosts", "fit_tick_costs"]


# ---------------------------------------------------------------------------
# 1. Cost graphs
# ---------------------------------------------------------------------------

_DTYPE = {"bfloat16": "bf16", "float16": "f16", "float32": "f32",
          "float8_e4m3fn": "f8e4m3fn"}


def _elem_bytes(cfg: ModelConfig) -> int:
    return BYTES_PER_ELEM[_DTYPE.get(cfg.dtype, "bf16")]


def _layer_ff(cfg: ModelConfig, idx: int) -> int:
    """Active FFN width of layer ``idx`` (MoE: only routed + shared
    experts run per token — that is what is computed AND streamed)."""
    if cfg.layer_is_moe(idx):
        moe = cfg.moe
        return moe.top_k * moe.d_ff_expert + moe.n_shared * moe.d_ff_shared
    return cfg.d_ff


def _mixer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(attention layers, non-attention mixer layers)."""
    attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    return attn, cfg.n_layers - attn


def _sharded(x: int, tp: int) -> int:
    return max(1, x // tp)


def _per_token_dots(cfg: ModelConfig, m: int, ctx: float, tp: int,
                    n_mlp: int) -> List[KernelOp]:
    """The dot ops for ``m`` tokens advancing one step through every
    layer at mean attention context ``ctx``.  ``n_mlp`` is the layer
    multiplier carried on the MLP ops (collapsed MoE/dense mean width).

    Non-attention mixers (SSM/hybrid layers) are approximated as their
    in/out projections — their scan is memory-shaped, which the memory
    op already carries; built-in scenarios all serve attention archs.
    """
    d = cfg.d_model
    H = _sharded(cfg.n_heads, tp)
    KV = _sharded(cfg.n_kv_heads, tp)
    hd = cfg.hd
    dt = _DTYPE.get(cfg.dtype, "bf16")
    n_attn, n_ssm = _mixer_counts(cfg)
    ctx_i = max(1, int(round(ctx)))
    mean_ff = sum(_layer_ff(cfg, i) for i in range(cfg.n_layers)) \
        / max(1, cfg.n_layers)
    ffs = max(1, int(round(mean_ff / tp)))
    ops = [
        # attention projections
        KernelOp(kind="dot", opcode="dot", count=float(n_attn), dtype=dt,
                 batch=1, m=m, n=(H + 2 * KV) * hd, k=d),
        KernelOp(kind="dot", opcode="dot", count=float(n_attn), dtype=dt,
                 batch=1, m=m, n=d, k=H * hd),
        # attention score / value contractions at the mean context
        KernelOp(kind="dot", opcode="dot", count=float(n_attn), dtype=dt,
                 batch=m * H if m == 1 else H, m=m if m > 1 else 1,
                 n=ctx_i, k=hd),
        KernelOp(kind="dot", opcode="dot", count=float(n_attn), dtype=dt,
                 batch=m * H if m == 1 else H, m=m if m > 1 else 1,
                 n=hd, k=ctx_i),
        # MLP (gate/up + down; gelu archs just have a fatter mean width)
        KernelOp(kind="dot", opcode="dot", count=float(n_mlp), dtype=dt,
                 batch=1, m=m, n=2 * ffs if cfg.mlp_type == "swiglu" else ffs,
                 k=d),
        KernelOp(kind="dot", opcode="dot", count=float(n_mlp), dtype=dt,
                 batch=1, m=m, n=d, k=ffs),
        # LM head (the decode graph emits one token per slot per tick)
        KernelOp(kind="dot", opcode="dot", count=1.0, dtype=dt,
                 batch=1, m=m, n=_sharded(cfg.vocab_size, tp), k=d),
    ]
    if n_ssm:
        e = cfg.ssm.expand if cfg.ssm else 2
        ops.append(KernelOp(kind="dot", opcode="dot", count=float(n_ssm),
                            dtype=dt, batch=1, m=m,
                            n=_sharded(2 * e * d, tp), k=d))
        ops.append(KernelOp(kind="dot", opcode="dot", count=float(n_ssm),
                            dtype=dt, batch=1, m=m, n=d,
                            k=_sharded(e * d, tp)))
    return [op for op in ops if op.m > 0 and op.n > 0 and op.k > 0]


def _param_bytes(cfg: ModelConfig, tp: int) -> float:
    """Per-device bytes of *active* weights one token's forward streams
    (MoE counts routed+shared experts only; LM head included, embedding
    gather negligible)."""
    d = cfg.d_model
    H = _sharded(cfg.n_heads, tp)
    KV = _sharded(cfg.n_kv_heads, tp)
    hd = cfg.hd
    n_attn, n_ssm = _mixer_counts(cfg)
    n_mats = 3 if cfg.mlp_type == "swiglu" else 2
    total = 0.0
    total += n_attn * (d * (H + 2 * KV) * hd + H * hd * d)
    for i in range(cfg.n_layers):
        total += n_mats * d * (_layer_ff(cfg, i) / tp)
    if n_ssm:
        e = cfg.ssm.expand if cfg.ssm else 2
        total += n_ssm * (_sharded(2 * e * d, tp) * d
                          + d * _sharded(e * d, tp))
    total += _sharded(cfg.vocab_size, tp) * d        # LM head
    return total * _elem_bytes(cfg)


def _tp_collectives(cfg: ModelConfig, m: int, tp: int) -> List[KernelOp]:
    """Two all-reduces per layer (post-attention, post-MLP) of the
    activation rows, ring wire accounting as in perf.hlo_ir."""
    if tp <= 1:
        return []
    result = float(m * cfg.d_model * _elem_bytes(cfg))
    wire = result * 2.0 * (tp - 1) / tp              # ring all-reduce
    return [KernelOp(kind="collective", opcode="all-reduce",
                     count=2.0 * cfg.n_layers, dtype="",
                     bytes=result, wire_bytes=wire, group=tp)]


def _finish(ops: List[KernelOp], mem_bytes: float, key: str) -> KernelGraph:
    ops = list(ops)
    ops.append(KernelOp(kind="memory", opcode="hbm-stream", count=1.0,
                        bytes=mem_bytes))
    return KernelGraph(
        ops=ops,
        flops=float(sum(op.count * op.flops for op in ops)),
        bytes_accessed=mem_bytes,
        collective_wire=float(sum(op.count * op.wire_bytes for op in ops)),
        key=key, source="totals")


def analytic_graphs(scn: TrafficScenario,
                    cfg: Optional[ModelConfig] = None
                    ) -> Dict[str, KernelGraph]:
    """``{"decode": ..., "prefill": ...}`` cost graphs for a scenario.

    Deterministic and capture-free: realistic fleet numbers come from
    the FULL catalog config's dimensions, not from running the model.
    """
    cfg = cfg or get_config(scn.arch)
    tp, B, C = scn.tp, scn.max_batch, scn.prefill_chunk
    eb = _elem_bytes(cfg)
    n_attn, _ = _mixer_counts(cfg)
    KV = _sharded(cfg.n_kv_heads, tp)

    # decode tick: every slot advances one token; m=1 dots are batched
    # over the B slots via count (each slot is its own tiny GEMM)
    dec_ops = []
    for op in _per_token_dots(cfg, 1, scn.context_mean, tp,
                              n_mlp=cfg.n_layers):
        dec_ops.append(dataclasses.replace(op, count=op.count * B))
    dec_ops += _tp_collectives(cfg, B, tp)
    kv_read = B * scn.context_mean * KV * cfg.hd * 2 * eb * n_attn
    dec_mem = _param_bytes(cfg, tp) + kv_read
    decode = _finish(
        dec_ops, dec_mem,
        key=(f"fleet:{scn.name}:{cfg.name}:decode:B{B}"
             f":ctx{int(scn.context_mean)}:tp{tp}"))

    # prefill chunk: C prompt tokens of ONE request; mean attended
    # context over a prompt's chunks is half the prompt
    ctx_p = max(float(C), scn.prompt_mean / 2.0)
    pre_ops = _per_token_dots(cfg, C, ctx_p, tp, n_mlp=cfg.n_layers)
    pre_ops += _tp_collectives(cfg, C, tp)
    kv_write = C * KV * cfg.hd * 2 * eb * n_attn
    kv_reread = ctx_p * KV * cfg.hd * 2 * eb * n_attn
    pre_mem = _param_bytes(cfg, tp) + kv_write + kv_reread
    prefill = _finish(
        pre_ops, pre_mem,
        key=(f"fleet:{scn.name}:{cfg.name}:prefill:C{C}"
             f":ctx{int(ctx_p)}:tp{tp}"))
    return {"decode": decode, "prefill": prefill}


def torch_graphs(scn: TrafficScenario) -> Dict[str, KernelGraph]:
    """Opt-in captured cost source: one decode step and one prefill of
    the port's plain path (``use_kernels=False``) on the *reduced*
    config, recorded on the meta device by
    :func:`repro_torch.perf.torch_graph.capture` (the reference lowers
    and compiles the same two calls through XLA).  Batch, cache length
    and chunk are the reference's arithmetic.  Sized to the smoke config
    — use the analytic graphs for catalog-scale planning numbers and
    this path to sanity-check graph *structure*.
    """
    from repro_torch.models import decode_step, prefill
    from repro_torch.perf.torch_graph import (capture, meta_cache,
                                              meta_params, meta_tokens)

    cfg = dataclasses.replace(get_config(scn.arch).reduced(),
                              use_kernels=False)
    B = scn.max_batch
    T = min(512, 1 << max(4, int(math.ceil(
        math.log2(max(2.0, scn.context_mean / 16.0))))))
    params = meta_params(cfg)
    dec = capture(decode_step, cfg, params, meta_cache(cfg, B, T),
                  meta_tokens((B, 1)), T // 2)

    C = min(scn.prefill_chunk, T // 2)
    pre = capture(prefill, cfg, params, {"tokens": meta_tokens((1, C))}, T)
    return {"decode": dec, "prefill": pre}


# ---------------------------------------------------------------------------
# 2. ServeCost
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeCost:
    """The two scheduler primitives, costed on one device."""

    scenario: str
    device: str
    decode_tick_s: float            # whole batch advances one token
    prefill_chunk_s: float          # one chunk of one prompt
    decode_bound: str               # Report.bound of the decode graph
    prefill_bound: str
    max_batch: int
    prefill_chunks_per_request: int
    decode_report: Report = dataclasses.field(repr=False, default=None)
    prefill_report: Report = dataclasses.field(repr=False, default=None)

    @property
    def peak_tokens_per_s(self) -> float:
        """Decode-only ceiling: a full batch every tick."""
        if self.decode_tick_s <= 0:
            return math.inf
        return self.max_batch / self.decode_tick_s


def serve_cost(scenario: Union[TrafficScenario, str],
               device: str, *,
               overlay: Optional[Overlay] = None,
               engine: str = "roofline",
               source: str = "analytic") -> ServeCost:
    """Cost one scenario's scheduler primitives on one device.

    ``source="analytic"`` prices :func:`analytic_graphs`; any other
    value the captured :func:`torch_graphs`."""
    from repro_torch.fleet.scenario import get_scenario
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    graphs = analytic_graphs(scn) if source == "analytic" \
        else torch_graphs(scn)
    reps = {}
    for kind, g in graphs.items():
        reps[kind] = predict(g, device=device, engine=engine,
                             overlays=overlay,
                             workload_name=f"{scn.name}/{kind}")
    return ServeCost(
        scenario=scn.name, device=reps["decode"].device,
        decode_tick_s=reps["decode"].total_time_s,
        prefill_chunk_s=reps["prefill"].total_time_s,
        decode_bound=reps["decode"].bound,
        prefill_bound=reps["prefill"].bound,
        max_batch=scn.max_batch,
        prefill_chunks_per_request=scn.prefill_chunks_per_request,
        decode_report=reps["decode"], prefill_report=reps["prefill"])


# ---------------------------------------------------------------------------
# 3. Queueing model (all rates are per device/replica)
# ---------------------------------------------------------------------------

def request_work_s(scn: TrafficScenario, cost: ServeCost) -> float:
    """Server-seconds one mean request occupies a replica."""
    prefill = scn.prefill_chunks_per_request * cost.prefill_chunk_s
    decode = scn.output_mean * cost.decode_tick_s / scn.max_batch
    return prefill + decode


def _rho(qps: float, scn: TrafficScenario, cost: ServeCost) -> float:
    return qps * request_work_s(scn, cost)


def token_latency_s(qps: float, scn: TrafficScenario,
                    cost: ServeCost) -> float:
    """Mean inter-token latency at per-device rate ``qps``: the decode
    tick, stretched by the prefill chunks interleaved between ticks."""
    phi = qps * scn.prefill_chunks_per_request * cost.prefill_chunk_s
    if phi >= 1.0:
        return math.inf
    return cost.decode_tick_s / (1.0 - phi)


def ttft_s(qps: float, scn: TrafficScenario, cost: ServeCost) -> float:
    """p99-flavoured time to first token: the full prompt's prefill,
    inflated by queueing growth."""
    rho = _rho(qps, scn, cost)
    if rho >= 1.0:
        return math.inf
    prefill = scn.prefill_chunks_per_request * cost.prefill_chunk_s
    return prefill * (1.0 + scn.burstiness * rho / (1.0 - rho))


def p99_latency_s(qps: float, scn: TrafficScenario,
                  cost: ServeCost) -> float:
    """p99 inter-token latency at per-device rate ``qps``.  Strictly
    increasing in ``qps`` (every factor is), infinite at overload."""
    rho = _rho(qps, scn, cost)
    if rho >= 1.0:
        return math.inf
    lat = token_latency_s(qps, scn, cost)
    return lat * (1.0 + scn.burstiness * rho / (1.0 - rho))


def max_sustainable_qps(scn: TrafficScenario, cost: ServeCost, *,
                        slo: Optional[SLO] = None,
                        tol: float = 1e-6) -> float:
    """Largest per-device QPS meeting the SLO (0.0 if even an idle
    device misses it — e.g. the decode tick alone exceeds the p99
    target).  Bisection is exact here because the latency model is
    strictly monotonic in QPS by construction.
    """
    slo = slo or scn.slo
    p99_t = slo.p99_token_ms / 1e3
    ttft_t = slo.ttft_p99_ms / 1e3

    def ok(q: float) -> bool:
        return (p99_latency_s(q, scn, cost) <= p99_t
                and ttft_s(q, scn, cost) <= ttft_t)

    if cost.decode_tick_s <= 0:
        return math.inf
    if not ok(0.0):
        return 0.0
    lo, hi = 0.0, 1.0 / request_work_s(scn, cost)    # rho = 1 at hi
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if ok(mid):
            lo = mid
        else:
            hi = mid
        if hi - lo <= tol * max(1.0, hi):
            break
    return lo


# ---------------------------------------------------------------------------
# Calibration: deterministic replica of the paged scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimStats:
    """Tick accounting of one simulated trace (field names match the
    serve layer's RunStats where they overlap).  The resilience counters
    default to 0 so pre-resilience constructor calls keep working."""

    requests: int
    tokens: int
    ticks: int
    decode_steps: int
    prefill_chunks: int
    occupancy_mean: float
    occupancy_max: float
    completed: int = 0              # requests that ended with status OK
    shed: int = 0
    timeouts: int = 0
    cancelled: int = 0
    preemptions: int = 0
    stalled_ticks: int = 0


def simulate_trace(trace: Sequence[Union[Request, Tuple]], *,
                   max_len: int, max_batch: int, page: int,
                   n_blocks: Optional[int] = None,
                   prefill_chunk: int = 32,
                   max_queue: Optional[int] = None,
                   admission=None, max_preemptions: int = 8,
                   fault_plan=None,
                   max_ticks: Optional[int] = None) -> SimStats:
    """Replay the ``PagedServeEngine`` scheduler on the host — no model,
    no device — and return its tick accounting.

    Models a ``prefix_cache=False`` engine (the calibration baseline:
    block sharing changes *which* chunks run, not the tick structure's
    cost shape).  The tick loop mirrors ``PagedServeEngine.run``
    step-for-step — the canonical 8-step order documented in
    :mod:`repro_torch.serve.resilience`: faults, cancellations, timeouts,
    forced preemptions, shed (queue cap then the pluggable policy), FIFO
    admission under slot + *prompt*-block backpressure, one prefill
    chunk per prefilling slot, then block growth (exhaustion preempts
    victims latest-admitted first) and one decode step for all actives.
    ``ticks`` / ``decode_steps`` / ``prefill_chunks`` and every
    resilience counter match the real engine exactly on any trace —
    including overload traces with deadlines, bounded queues, and a
    ``FaultPlan``.  Pass the *same* ``admission`` policy and
    ``fault_plan`` objects the engine ran with: both are pure host logic
    whose effects are functions of the tick, so sharing the instances is
    safe.  ``trace`` holds :class:`~repro_torch.serve.api.Request`
    objects or legacy ``(prompt, n_steps[, arrival])`` tuples, coerced
    with a one-shot ``DeprecationWarning`` as the engines coerce them.
    """
    from repro_torch.serve.resilience import (OK, PREEMPTED, QueueCapPolicy,
                                              queue_entries)
    reqs = as_requests(trace)
    nb_table = math.ceil(max_len / page)
    if n_blocks is None:
        n_blocks = max_batch * nb_table + 1
    capacity = n_blocks - 1                          # null block reserved
    for i, r in enumerate(reqs):
        s = r.prompt.shape[0]
        if s + r.n_steps > max_len:
            raise ValueError(f"request {i} does not fit max_len {max_len}")
        if math.ceil((s + r.n_steps) / page) > capacity:
            raise ValueError(
                f"request {i} needs {math.ceil((s + r.n_steps) / page)} "
                f"blocks but the pool's capacity is {capacity} blocks")

    policies = []
    if max_queue is not None:
        policies.append(QueueCapPolicy(max_queue))
    if admission is not None:
        policies.append(admission)

    queue = collections.deque(
        sorted(range(len(reqs)), key=lambda i: (reqs[i].arrival, i)))
    # slot state: None or [req_idx, filled, remaining, blocks, kv_len, seq]
    slots: List[Optional[list]] = [None] * max_batch
    free_blocks = capacity
    seized: List[list] = []                          # [release_tick, k]
    seq_counter = 0
    emitted = [0] * len(reqs)                        # tokens kept per request
    preempt_count = [0] * len(reqs)
    done = [False] * len(reqs)

    tick = decode_steps = prefill_chunks = 0
    n_ok = n_shed = n_timeout = n_cancel = n_preempt = n_stalled = 0
    occupancy: List[float] = []

    def finish(rid: int, status: str) -> None:
        done[rid] = True
        nonlocal n_ok
        if status == OK:
            n_ok += 1

    def clear_slot(si: int) -> None:
        nonlocal free_blocks
        free_blocks += slots[si][3]
        slots[si] = None

    def drop_queued(rids, status: str) -> None:
        nonlocal queue
        dropped = set(rids)
        if not dropped:
            return
        queue = collections.deque(r for r in queue if r not in dropped)
        for rid in rids:
            finish(rid, status)

    def preempt(si: int) -> None:
        nonlocal n_preempt
        rid = slots[si][0]
        clear_slot(si)
        preempt_count[rid] += 1
        n_preempt += 1
        if preempt_count[rid] > max_preemptions:
            finish(rid, PREEMPTED)                   # partial tokens kept
            return
        emitted[rid] = 0                             # recompute from scratch
        key = (reqs[rid].arrival, rid)
        pos = 0
        for pos, q in enumerate(queue):              # sorted re-insert
            if (reqs[q].arrival, q) > key:
                break
        else:
            pos = len(queue)
        queue.insert(pos, rid)

    def victims_latest_first() -> List[int]:
        held = [(slots[si][5], si) for si in range(max_batch)
                if slots[si] is not None]
        return [si for _, si in sorted(held, reverse=True)]

    while queue or any(s is not None for s in slots):
        if max_ticks is not None and tick >= max_ticks:
            raise RuntimeError(
                f"simulated scheduler exceeded max_ticks={max_ticks} — "
                "deadlock canary tripped")

        # 1. faults: release expired seizures, seize for faults firing now
        stalled = False
        if fault_plan is not None:
            keep = []
            for rel in seized:
                if rel[0] <= tick:
                    free_blocks += rel[1]
                else:
                    keep.append(rel)
            seized = keep
            for f in fault_plan.seizures(tick):
                k = free_blocks if f.n is None else min(f.n, free_blocks)
                if k:
                    free_blocks -= k
                    seized.append([tick + f.duration, k])
            stalled = fault_plan.stalled(tick)
            if stalled:
                n_stalled += 1

        # 2. cancellations, then 3. timeouts (queued, then in-flight)
        cancelled = [rid for rid in queue
                     if reqs[rid].cancel_at is not None
                     and tick >= reqs[rid].cancel_at]
        drop_queued(cancelled, "CANCELLED")
        n_cancel += len(cancelled)
        for si in range(max_batch):
            if slots[si] is None:
                continue
            r = reqs[slots[si][0]]
            if r.cancel_at is not None and tick >= r.cancel_at:
                rid = slots[si][0]
                clear_slot(si)
                finish(rid, "CANCELLED")
                n_cancel += 1
        timed_out = [rid for rid in queue
                     if reqs[rid].deadline is not None
                     and tick > reqs[rid].deadline]
        drop_queued(timed_out, "TIMEOUT")
        n_timeout += len(timed_out)
        for si in range(max_batch):
            if slots[si] is None:
                continue
            r = reqs[slots[si][0]]
            if r.deadline is not None and tick > r.deadline:
                rid = slots[si][0]
                clear_slot(si)
                finish(rid, "TIMEOUT")
                n_timeout += 1

        # 3b. fault-forced preemptions (latest-admitted first)
        if fault_plan is not None:
            for si in victims_latest_first()[
                    :fault_plan.forced_preemptions(tick)]:
                preempt(si)

        # 4. shed: queue-cap bound first, then the pluggable policy
        if policies:
            for policy in policies:
                waiting = [rid for rid in queue if reqs[rid].arrival <= tick]
                if not waiting:
                    break
                entries = queue_entries(tick, waiting, reqs, prefill_chunk)
                verdicts = dict(policy.shed(tick, entries))
                drop_queued(list(verdicts), "SHED")
                n_shed += len(verdicts)

        # 5. admit (FIFO while a slot and the PROMPT reservation fit)
        while not stalled and queue and reqs[queue[0]].arrival <= tick:
            free_slots = [i for i, s in enumerate(slots) if s is None]
            if not free_slots:
                break
            rid = queue[0]
            r = reqs[rid]
            need = max(1, math.ceil(r.prompt.shape[0] / page))
            if need > free_blocks:
                break                                # wait for retirements
            queue.popleft()
            free_blocks -= need
            si = free_slots[0]
            slots[si] = [rid, 0, r.n_steps, need, 0, seq_counter]
            seq_counter += 1

        occupancy.append((capacity - free_blocks) / capacity
                         if capacity else 0.0)

        # 6. one prefill chunk per PREFILLING slot
        for si in range(max_batch):
            slot = slots[si]
            if stalled or slot is None or slot[4] > 0:
                continue
            rid = slot[0]
            s = reqs[rid].prompt.shape[0]
            slot[1] = min(s, slot[1] + prefill_chunk)
            prefill_chunks += 1
            if slot[1] == s:                         # prefill done -> ACTIVE
                emitted[rid] += 1
                slot[2] -= 1
                slot[4] = s
                if slot[2] == 0:
                    clear_slot(si)
                    finish(rid, OK)

        # 7a. grow: ACTIVE slots crossing a page boundary allocate their
        # next block; exhaustion preempts latest-admitted first
        for si in range(max_batch):
            if stalled:
                break
            slot = slots[si]
            if slot is None or slot[4] == 0:
                continue
            if slot[4] < slot[3] * page:
                continue                             # page not full yet
            got = free_blocks >= 1
            if not got:
                for vi in victims_latest_first():
                    victim_is_self = vi == si
                    preempt(vi)
                    if victim_is_self:
                        break
                    if free_blocks >= 1:
                        got = True
                        break
            if not got or slots[si] is None:
                continue                             # grower was evicted
            free_blocks -= 1
            slot[3] += 1

        # 7b. one decode step for every ACTIVE slot
        actives = [] if stalled else \
            [si for si in range(max_batch)
             if slots[si] is not None and slots[si][4] > 0]
        if actives:
            decode_steps += 1
            for si in actives:
                slot = slots[si]
                rid = slot[0]
                emitted[rid] += 1
                slot[2] -= 1
                slot[4] += 1
                if slot[2] == 0:
                    clear_slot(si)
                    finish(rid, OK)
        tick += 1

    # mirror the engine: a run ending inside a seizure window hands the
    # fault-held blocks back before the pool accounting is reported
    for rel in seized:
        free_blocks += rel[1]
    seized = []

    return SimStats(
        requests=len(reqs), tokens=sum(emitted), ticks=tick,
        decode_steps=decode_steps, prefill_chunks=prefill_chunks,
        occupancy_mean=float(np.mean(occupancy)) if occupancy else 0.0,
        occupancy_max=float(np.max(occupancy)) if occupancy else 0.0,
        completed=n_ok, shed=n_shed, timeouts=n_timeout,
        cancelled=n_cancel, preemptions=n_preempt, stalled_ticks=n_stalled)


@dataclasses.dataclass(frozen=True)
class TickCosts:
    """Per-primitive wall costs of the real engine, fitted from runs."""

    decode_s: float
    prefill_s: float
    overhead_s: float                # per-tick scheduler overhead

    def wall_s(self, stats) -> float:
        """Predicted wall for any stats carrier with ``decode_steps`` /
        ``prefill_chunks`` / ``ticks`` (RunStats or SimStats)."""
        return (self.decode_s * stats.decode_steps
                + self.prefill_s * stats.prefill_chunks
                + self.overhead_s * stats.ticks)

    def token_latency_s(self, stats) -> float:
        return self.wall_s(stats) / max(1, stats.tokens)


def fit_tick_costs(observations: Iterable[Tuple[object, float]]
                   ) -> TickCosts:
    """Least-squares fit of (decode_s, prefill_s, overhead_s) from
    ``(stats, measured_wall_s)`` pairs (>= 3 runs with linearly
    independent tick mixes).  Costs are clamped at >= 0 — a negative
    fitted primitive means the probe mixes were degenerate."""
    rows, walls = [], []
    for stats, wall in observations:
        rows.append([stats.decode_steps, stats.prefill_chunks, stats.ticks])
        walls.append(wall)
    if len(rows) < 3:
        raise ValueError("need >= 3 observations to fit 3 tick costs")
    sol, *_ = np.linalg.lstsq(np.asarray(rows, float),
                              np.asarray(walls, float), rcond=None)
    d, p, o = (max(0.0, float(v)) for v in sol)
    return TickCosts(decode_s=d, prefill_s=p, overhead_s=o)
