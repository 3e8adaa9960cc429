#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; a failed
greedy-stream check lets the later phases run first, since none of them
depends on it, so that one run reports every such failure):

1. set-up: the card's name and power limit, and the CUDA kernels built
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel check: each kernel against its plain PyTorch version on the
   card at the shapes the serving paths give it (paged decode at B = 8,
   its unused table slots on a poisoned null block;
   flash attention over a 2048-row causal prefill, a ragged 2000-row one,
   one with kv_len < T and one at qwen3-moe's grouping G = 16; contiguous
   decode at B = 8 over a 2048-row cache of mixed lengths, rows past them
   poisoned, at B = 4 and at B = 1 with length 2000), then timed beside
   the plain version, the PyTorch library call that computes the same
   function, and the least time the card could take; the attention
   kernels and their library calls also by the profiler's device time,
   and each wrapper by its host time a call;
3. paged serve: ``PagedServeEngine`` on full-width qwen2-7b (random bf16
   weights from a seed) answers 8 shared-prefix requests of 16 greedy
   tokens; every request must end OK and the paged-decode kernel must
   have launched once per layer per decode tick.  Then one decode tick
   on an identical pool through the plain path must give the same
   logits (relative error < 2e-2, and the kernel path no further from a
   float32 run of the tick than 1.5x the plain path), and the trace
   replayed through the plain path may differ only at near-ties (top-2
   margin < 0.05);
4. sync serve: ``ServeEngine(max_len=2048)`` on the same model serves
   prompts of 2000, 1537, 1024 and 517 tokens one at a time
   (``run(batch=1)``), then one batch of 4 equal 1024-token prompts
   (``generate``), 16 greedy tokens each; the flash kernel must have
   launched once per layer per prefill and the decode kernel once per
   layer per decode step.  One decode step's logits against the plain
   path, and the greedy streams against the plain path's, as in 3;
5. engines against each other: the sync engine replays phase 3's trace
   and the paged engine's streams may differ from it only at near-ties;
6. profile: a paged decode tick and prefill chunk, a sync 2048-row
   prefill and a sync B = 4 decode step, host wall time against device
   time;
7. MoE kernel check: qwen2-7b is freed, and ``moe_gmm`` is held to its
   plain version at qwen3-moe's full width (128 experts, d_model 4096,
   d_ff_expert 1536) at the decode, prefill and a ragged shape, and
   timed beside ``torch.bmm`` and its bound (events, and the profiler's
   device time of both);
8. MoE paged serve: full-width qwen3-moe-235b-a22b cut in depth to 8 of
   94 layers (random bf16 weights from a seed, ~42 GB) serves phase 3's
   trace; every request OK, ``moe_gmm`` launched 3 x n_layers x (decode
   ticks + prefill chunks) and the paged kernel n_layers x decode ticks.
   One decode tick against the plain path with its routing logged: a
   token whose top-8 experts differ on the two paths must be a routing
   near-tie (plain top-8/top-9 probability margin < 1e-3 at its first
   differing layer), the other tokens' logits within 2e-2; the greedy
   streams against the plain path's may differ only at a logit near-tie
   or at a routing near-tie (the first differing routing along the
   teacher-forced stream);
9. MoE sync serve: prompts of 2000 and 517 tokens one at a time at
   ``max_len`` 2048; flash n_layers x prefills, decode n_layers x decode
   steps, ``moe_gmm`` 3 x n_layers x (prefills + decode steps); the same
   checks on a decode step of 8 x 512-token prompts and on the streams
   (the two engines are not compared on MoE: capacity depends on each
   step's length, so they compute different functions);
10. MoE profile: a paged decode tick and a sync B = 8 decode step;
11. SSD kernel check: qwen3-moe is freed, and ``mamba2_ssd`` is held to
    its plain version at mamba2-370m's full width (32 heads of 64, d_state
    128) over a 2048-row prefill and a ragged 2000-row one, and at
    jamba's (128 heads of 64, d_state 16) over 2000 rows, output and
    final state, and timed beside its plain version and its bound, also
    by the profiler's device time of the three CUDA kernels a call
    enqueues and by the wrapper's host time a call;
12. SSM sync serve: full-width, full-depth mamba2-370m (48 SSM layers,
    random bf16 weights from a seed) through ``ServeEngine(max_len=2048)``:
    prompts of 2000, 1537, 1024 and 517 tokens one at a time, then one
    batch of 4 equal 1024-token prompts, 16 greedy tokens each;
    ``mamba2_ssd`` launched 2 x 48 x prefills (the layer's output and the
    state it hands to decode).  Then the precision checks, in two types:
    48 random-weight SSM layers amplify rounding so far that the plain
    path's own bf16 logits lie ~30% from its float32 ones, past any
    limit meant for rounding.  So in bf16 one prefill's and one decode
    step's logits are held to the float32 yardstick of 3 only (the
    kernel path no further from float32 than 1.5x the plain path), and
    the state handoff and the streams are printed; in float32 (the same
    weights upcast) the prefill and decode-step logits are held within
    2e-2 of the plain path, the state handoff (a decode step after a
    prefill of S - 1 tokens against ``forward``'s logits at S) within
    3e-2 as the reference's own test, and the streams of ``run(batch=1)``
    to the plain path's up to near-ties;
13. SSM profile: a mamba2 B = 1 decode step and a 2048-row prefill (and
    the SSD kernels' share of the prefill's device time);
14. hybrid sync serve: jamba-v0.1-52b at full width cut in depth to one
    8-layer period (7 SSM layers, attention at index 4, 4 MoE and 4
    dense FFNs; random bf16 weights, ~26.5 GB) serves prompts of 2000 and
    517 tokens; ``mamba2_ssd`` 2 x 7 x prefills, flash 1 x prefills,
    decode 1 x decode steps, ``moe_gmm`` 3 x 4 x (prefills + decode
    steps); a decode step of 8 x 512-token prompts and the streams held
    to the plain path by the MoE rules of 9;
15. the MFMA contract: jamba is freed, and ``mfma_gemm`` (D = C + A @ B,
    bf16/f16 operands on the tensor cores: ``wgmma`` fed by TMA at M >
    64, ``mma.sync`` at the decode rows) is held to its plain version
    at kernels_bench's 256^3, qwen2-7b's gate/up projection at decode
    (M = 8) and prefill (M = 2048) and its down projection at prefill, a
    ragged shape, f32 and f16 operands and a bf16 C, the bf16 shapes with
    f32 C (256^3, decode, prefill gate/up and down) timed beside
    ``torch.addmm(..., out_dtype=float32)`` and their bound, by events,
    by the profiler's device time (both) and by the wrapper's host time;
    then, counted, the contract path: C = 3 against C = 0 exactly
    3 apart at the decode and prefill shapes, the GEMM against
    compositions of ``core.functional.mfma_apply`` micro-ops
    (fp32_16x16x4fp32, fp32_16x16x16bf16) on the card, and every
    registry instruction's ``mfma_apply`` on the card against the CPU;
16. the dense catalog: internlm2-20b (G = 6), mistral-nemo-12b (head dim
    128 where d_model / H is 160) and yi-34b (G = 7) at full width, each
    cut in depth to 8 layers (random bf16 weights, ~8.4, ~7.0 and ~10.8
    GB): phase 2's kernel checks and timings at its grouping, phase 3's
    paged serve (8 shared-prefix requests; paged n_layers x ticks) and
    the sync engine on prompts of 2000 and 517 tokens (flash n_layers x
    prefills, decode n_layers x steps), each with phase 3 and 4's logit
    and stream checks;
17. deepseek-v2-lite-16b at full width and depth (27 layers: MLA, one
    dense FFN layer, 26 MoE layers of 64 experts top-6 and 2 shared
    experts; ~31 GB): ``moe_gmm`` held to its plain version at its decode
    and prefill shapes and timed beside ``torch.bmm`` and its bound; the
    sync engine on prompts of 2000 and 517 tokens (``moe_gmm`` 3 x 26 x
    steps, flash and decode 0: MLA attends on the plain path); the
    streams by phase 9's rules; a decode step of 8 x 512-token prompts
    held to float32 (the weights converted in place): the kernel path's
    logits and its routing no further from float32's than 1.5x the plain
    path's, phase 9's routing rule printed beside the plain path's own
    token-by-token run (at this depth the rule does not hold between the
    plain path and itself);
18. llama-3.2-vision-90b at full width cut to two 5-layer periods (8 self-
    and 2 gated cross-attention layers, ~21.3 GB), gates and (1, 4100,
    8192) media from the seed: non-causal flash at S = 2000, T = 4100
    and decode over 4100 media rows (B = 1 and 8) held to their plain
    versions and timed beside SDPA and their bounds; then ``prefill`` and
    16 greedy ``decode_step`` s for prompts of 2000 and 517 tokens (flash
    10 x prefills, decode 10 x steps), a prefill's and a decode step's
    logits against the plain path with the float32 yardstick, and the
    streams against the plain path's;
19. whisper-base at full width and depth (6 encoder layers over (1,
    1500, 512) frames from the seed, 6 decoder layers): non-causal flash
    at S = T = 1500 held and timed beside SDPA and its bound,
    ``_encode`` held to the plain path's (2e-2), then the greedy loops
    of 18 for prompts of 448 and 117 tokens (flash 12 x prefills,
    decode 6 x steps);
20. training on the plain path (no kernel has a backward, in either
    package; none may launch): qwen2-7b at full width cut to 4 of 28
    layers (~2.0 B params, random bf16 weights from a seed), remat
    "full", 2 microbatches, on ``SyntheticLM`` batches of 4 x 1024
    tokens through ``prefetch_to_device``.  (a) step 0's gradient
    against a float32 copy's, before any optimizer state exists: the
    whole gradient's relative norm error < 5e-2, the cosine between the
    two >= 0.99, the CE within 1e-2 of float32's, the worst leaf
    printed; (b) 8 AdamW steps (lr 1e-3, 2 warm-up steps): the mean of
    the last 3 losses below step 0's; (c) the mean wall time of steps
    2-7, tokens/s, the model-FLOP share of the bf16 peak, one profiled
    step's device time, launches, idle share and cuBLAS share, the
    forward and backward apart from the AdamW update, peak device
    memory;
    (d) ``examples/torch_train_lm.py``'s smoke preset under the
    controller, 30 steps, checkpoints every 10, a ``WorkerFailure`` at
    step 15: one restart, and the final parameters within 1e-2 relative
    norm of an uninterrupted run's (the embedding backward's atomics
    make runs on the card differ in their last bits).
21. the paper's timing model and its Listing-1 microbenchmark on the
    card (``repro_torch.core``, ``kernels/listing1.py``): (a) Tables
    II-V's Expected column from ``latency_table`` on mi200 and mi300 for
    N in 2..5 exactly, and Table VI (``scale_table`` at --mfma-scale 2
    doubles every mi300 latency); (b) ``csrc/listing1.cu``, one warp
    reading ``%clock64`` around N dependent ``mma.sync`` (f64 m8n8k4,
    tf32 m16n8k8, f16 and bf16 m16n8k16, s8 m16n8k32), 50 launches of
    each variant at N in 0..5, counted (N = 0 measures the probe
    overhead, N = 1 one mma's issue), D equal to the plain version
    C + N A B exactly in every launch (integer-valued operands); (c)
    the median T_total positive and strictly increasing in N, and,
    recorded without a limit, Eq. 1 through the port's ``eq1_latency``
    (t_memtime the overhead, t_inst 0, and again with t_inst the issue)
    beside a least-squares slope over N and the spread across N.  The
    cycles stay out of the H100's cycle table.
22. the paper's performance pipeline over the port's own model
    (``repro_torch.perf``; no weights, no kernel): (a) ``capture``
    records full-width (28-layer) qwen2-7b's plain-path graphs of phase
    6's two steps on the meta device, the sync prefill of 2048 rows at
    B = 1 and the decode step at B = 4, position 1024, and their dot
    FLOPs must equal the closed form of ``qwen_step_flops`` exactly; (b)
    ``predict(graph, device="h100", engine="roofline")`` (kernel
    adjusted) beside phase 6's profiled device time of the same step on
    the kernel path and their ratio: each measured time must be at least
    its roofline; (c) ``workload_grid(graph, "mi300x",
    mfma_scale=(0.5, 1, 2))`` through the ``mfma`` engine, whose time
    must double exactly from scale 1 to 2, ``sweep`` over the
    reference's five devices x roofline/mfma/scoreboard printed with
    ``format_reports``, and the ``mfma`` and ``scoreboard`` engines on
    ``h100`` must raise; (d) the phase's wall time (under 30 s).

Each phase prints its wall time.  The last three lines are the card's
name and power limit, a JSON record of every kernel (with its timed
``shapes`` and ``launches_by_phase``) and ``{"ok": true, "device":
{...}}``.  It needs one GPU, ``nvcc`` (under
``$CUDA_HOME`` or ``/usr/local/cuda``) and no network; it never imports
jax or the reference package.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SERVE = dict(arch="qwen2-7b", requests=8, n_steps=16, prefix_len=128,
             max_len=256, max_batch=8, seed=0)
SYNC = dict(max_len=2048, prompts=(2000, 1537, 1024, 517), n_steps=16,
            batch=4, batch_len=1024, seed=1)
KERNEL_ATOL, KERNEL_RTOL = 2e-2, 1e-2     # ~2 bf16 ulps at |x| <= 2
LOGIT_REL_TOL = 2e-2
# qwen3-moe at full width, cut from 94 to 8 layers so that its ~42 GB of
# bf16 weights fit one 80 GB card beside the activations
MOE = dict(arch="qwen3-moe-235b-a22b", n_layers=8, seed=0)
MOE_SYNC = dict(max_len=2048, prompts=(2000, 517), n_steps=16,
                check_batch=(8, 512), seed=2)
# a token whose top-k and top-(k+1) router probabilities lie closer than
# this on the plain path may route differently under the kernel path's
# rounding: a routing near-tie (repro_torch.serve.parity)
ROUTING_MARGIN = 1e-3
# mamba2-370m at full width and depth: ~0.37 B params, ~0.74 GB in bf16
SSM = dict(arch="mamba2-370m", seed=3)
SSM_SYNC = dict(max_len=2048, prompts=(2000, 1537, 1024, 517), n_steps=16,
                batch=4, batch_len=1024, seed=4)
# jamba-v0.1-52b at full width, cut from 32 layers to one 8-layer period
# (~13.3 B params, ~26.5 GB in bf16; all 32 layers, ~103 GB, do not fit
# one 80 GB card)
HYBRID = dict(arch="jamba-v0.1-52b", n_layers=8, seed=5)
HYBRID_SYNC = dict(max_len=2048, prompts=(2000, 517), n_steps=16,
                   check_batch=(8, 512), seed=6)
# the MFMA GEMM's shapes (M, K, N, a/b dtype, c dtype, timed):
# kernels_bench's 256^3, qwen2-7b's gate/up projection (d_model 3584 ->
# d_ff 18944) at a decode step of 8 rows and a 2048-row prefill, its down
# projection at prefill, a ragged case with no dimension a multiple of 16
# (K % 8 != 0 also takes the one-element loads), f32 and f16 operands and
# a bf16 C
GEMM_CASES = {
    "256^3": (256, 256, 256, "bfloat16", "float32", True),
    "decode gate/up": (8, 3584, 18944, "bfloat16", "float32", True),
    "prefill gate/up": (2048, 3584, 18944, "bfloat16", "float32", True),
    "prefill down": (2048, 18944, 3584, "bfloat16", "float32", True),
    "ragged": (1999, 3580, 1000, "bfloat16", "float32", False),
    "f32 operands 256^3": (256, 256, 256, "float32", "float32", False),
    "f16 operands": (512, 3584, 1024, "float16", "float32", False),
    "bf16 C": (1024, 3584, 3584, "bfloat16", "bfloat16", False),
}
GEMM_RECORD = "prefill gate/up"
# the CUDA kernels one mamba2_ssd call enqueues
SSD_KERNELS = ("ssd_chunk_kernel", "ssd_scan_kernel", "ssd_output_kernel")
# the reference's limit for the prefill -> decode state handoff of its
# bf16 SSM model (tests/test_arch_smoke.py)
HANDOFF_TOL = 3e-2
# the dense catalog at full width, each cut to 8 layers (~8.4, ~7.0 and
# ~10.8 GB of bf16 weights; yi-34b's 60 layers, ~69 GB, leave the card no
# room, and the kernels see the same shapes at every layer)
DENSE = dict(archs=("internlm2-20b", "mistral-nemo-12b", "yi-34b"),
             n_layers=8, seed=7)
DENSE_SYNC = dict(max_len=2048, prompts=(2000, 517), n_steps=16, seed=8)
# deepseek-v2-lite-16b at full width and depth (~15.7 B params, ~31 GB)
MLA = dict(arch="deepseek-v2-lite-16b", seed=9)
MLA_SYNC = dict(max_len=2048, prompts=(2000, 517), n_steps=16,
                check_batch=(8, 512), seed=10)
# llama-3.2-vision-90b at full width cut to two 5-layer periods (8 self-
# and 2 cross-attention layers, ~10.7 B params, ~21.3 GB)
VLM = dict(arch="llama-3.2-vision-90b", n_layers=10, seed=11)
VLM_RUN = dict(max_len=2048, prompts=(2000, 517), n_steps=16, seed=12)
# whisper-base at full width and depth; its decoder's published context
# is 448 tokens
ENC = dict(arch="whisper-base", seed=13)
ENC_RUN = dict(max_len=512, prompts=(448, 117), n_steps=16, seed=14)
# training: qwen2-7b at full width cut to 4 of 28 layers (~2.02 B params:
# bf16 weights 4 GB, f32 moments 16 GB, and a functional step holds two
# states at its end, ~45 GB with the gradients; 8 layers would leave too
# little room for the activations on an 80 GB card)
TRAIN = dict(arch="qwen2-7b", n_layers=4, microbatches=2, seed=15,
             batch=4, seq_len=1024, steps=8, lr=1e-3, warmup_steps=2)
GRAD_REL_TOL = 5e-2     # the bf16 gradient's relative norm error
GRAD_COS_MIN = 0.99     # cosine of the bf16 and float32 gradients
CE_REL_TOL = 1e-2       # bf16 CE against float32's
# the controller on the training example's smoke preset
CONTROLLER = dict(preset="smoke", steps=30, ckpt_every=10, fail_at=15,
                  rel_tol=1e-2)
# the paper's Tables II-V, Expected column (cycles), for N in 2..5
PAPER_EXPECTED = {
    "mi200": {"fp64_16x16x4fp64": 32, "fp32_4x4x1fp32": 8,
              "fp32_16x16x4fp32": 32, "fp32_16x16x16fp16": 32,
              "i32_16x16x16i8": 32, "fp64_4x4x4fp64": 16,
              "fp32_4x4x4fp16": 8},
    "mi300": {"fp64_16x16x4fp64": 32, "fp32_4x4x1fp32": 8,
              "fp32_16x16x4fp32": 32, "fp32_16x16x16fp16": 16,
              "fp64_4x4x4fp64": 16, "fp32_4x4x4fp16": 8},
}
# the Listing-1 probe: chain lengths (0: the probe overhead; 1: one mma's
# issue), the launches whose median is read, and the variant and N of
# the kernels line's record
LISTING1 = dict(ns=(0, 1, 2, 3, 4, 5), launches=50, seed=21,
                record=("f16", 5))
# the perf pipeline's graphs: phase 6's sync prefill (B x S rows into a
# cache of max_len) and its decode step (B requests at position pos)
PERF = dict(prefill=dict(B=1, S=SYNC["max_len"], max_len=SYNC["max_len"]),
            decode=dict(B=SYNC["batch"], pos=SYNC["batch_len"],
                        max_len=SYNC["max_len"]),
            grid_device="mi300x", scales=(0.5, 1, 2),
            devices=("mi200", "mi300", "mi300x", "tpu_v5e", "tpu_v5p"),
            engines=("roofline", "mfma", "scoreboard"), max_s=30.0)


class Failure(Exception):
    """A phase failed; the message says which and why."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


DEFERRED: list = []     # failed checks that no later phase depends on


def check_later(ok: bool, msg: str) -> None:
    """A check whose failure the run reports at its end, after the later
    phases, which do not depend on it; it fails the run all the same."""
    if not ok:
        print(f"chip_smoke: FAILED (the run goes on, and fails at its "
              f"end): {msg}", file=sys.stderr)
        DEFERRED.append(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n: int, flush) -> float:
    """Mean device time of ``fn`` over ``n`` calls (after two warm-up
    calls), each timed by CUDA events with L2 flushed before it, as the
    serving path finds it after the other layers' weights went through."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in times) / n


def held_to_plain(torch, name: str, got, want) -> float:
    """Check a kernel's output against its plain version's: finite and
    within atol + rtol |want| everywhere; returns the max abs error."""
    err = (got.float() - want.float()).abs()
    max_abs_err = float(err.max())
    bad = err > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    check(not bool(bad.any()),
          f"{name} disagrees with its plain version: max abs err "
          f"{max_abs_err} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL})")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    return max_abs_err


def bound(nbytes: int, flops: int):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the operations over the bf16 tensor-core rate, both from the
    port's H100 spec (NVIDIA's data sheet: 3.35 TB/s, 989 TFLOP/s)."""
    from repro_torch.arch import get_device
    h100 = get_device("h100")
    bytes_ms = nbytes / h100.memory.hbm_bw * 1e3
    ops_ms = flops / h100.peak_flops * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def l2_flush(torch):
    """A function that overwrites 256 MB on the card, which flushes its
    50 MB L2 cache."""
    buf = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    return buf.zero_


def device_ms(torch, fn, n: int, flush) -> float:
    """Mean device time of ``fn``'s own kernels per call, from a profiler
    trace of ``n`` calls, each after ``flush``, that leaves the flush's
    fill kernels out (``fn`` itself launches no integer fill): what the
    card spends on a call whatever the host spends to launch it.  The
    trace on the card's machine sometimes loses an event (a call's
    kernel or a flush's fill), so a call's time is each of its kernels'
    mean time a launch times its launches a call (its count over ``n``,
    rounded), which a lost event changes neither way.  None when the
    trace holds no kernel of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace
    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    got = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0
           and "FillFunctor<int>" not in e.key
           and round(e.count / n) > 0]
    if not got:
        return None
    return sum(e.self_device_time_total / e.count * round(e.count / n)
               for e in got) / 1e3


def host_us(torch, fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds: ``n`` calls
    enqueued back to back, the card left to catch up after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def readings(rec, prefix: str = "", library: str = "sdpa") -> str:
    """The profiler's and the host's readings of a timed call, printed
    beside its event time."""
    def ms(x):
        return "not measured" if x is None else f"{x:.4f} ms"
    return (f"{prefix}device {ms(rec['device_ms'])} (profiler), {library} "
            f"device {ms(rec['library_device_ms'])}; wrapper host time "
            f"{rec['host_us']:.1f} us per call")


# -- phase 1 --------------------------------------------------------------

def phase_setup(torch):
    from repro_torch.kernels import build
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = build.build(names)
    print(f"build: {len(names)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({len(logs)} compiled, {len(names) - len(logs)} cached)")
    for name in names:
        for line in build.build_logs(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return card


# -- phase 2 --------------------------------------------------------------

def paged_decode_case(torch, cfg, page: int, nb: int, seed: int):
    """The serving path's decode-tick operands at full width: B = 8 slots
    of ragged length (partial pages, a page boundary, an idle slot at
    kv_len 1 on the null block), tables whose unused slots point at
    null block 0, which holds finite poison."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, KV, hd, H = 8, cfg.n_kv_heads, cfg.hd, cfg.n_heads
    P = B * nb + 1
    dt = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    q = randn(B, H, hd)
    k_pool, v_pool = randn(P, page, KV, hd), randn(P, page, KV, hd)
    k_pool[0], v_pool[0] = 30.0, -30.0
    lens = [193, 130, 64, 1, 150, 77, 200, nb * page]
    tables = torch.zeros((B, nb), dtype=torch.int32)
    for b, n in enumerate(lens):
        if b == 3:
            continue                                # idle slot: all null
        used = math.ceil(n / page)
        tables[b, :used] = torch.arange(1 + b * nb, 1 + b * nb + used)
    return (q, k_pool, v_pool, tables.to("cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def phase_kernels(torch, cfg, page: int, nb: int):
    import torch.nn.functional as F
    from repro_torch.kernels import (paged_decode_attention,
                                     paged_decode_attention_plain)
    q, kp, vp, tables, lens = paged_decode_case(torch, cfg, page, nb, seed=1)
    got = paged_decode_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    want = paged_decode_attention_plain(q, kp, vp, tables, lens)
    max_abs_err = held_to_plain(torch, "paged_decode_attention", got, want)
    print(f"paged_decode_attention B=8 H={cfg.n_heads} KV={cfg.n_kv_heads} "
          f"hd={cfg.hd} page={page} bf16: max_abs_err {max_abs_err:.3g}, "
          "null-block poison ignored")

    # the library yardstick: SDPA over the cache already gathered dense
    B, H, hd = q.shape
    kd = kp[tables.long()].reshape(B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
    vd = vp[tables.long()].reshape(B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True)

    def kernel():
        return paged_decode_attention(q, kp, vp, tables, lens)

    lib_err = float((library()[:, :, 0].float() - want.float()).abs().max())
    flush = l2_flush(torch)
    ms = time_ms(torch, kernel, 100, flush)
    plain_ms = time_ms(torch, lambda: paged_decode_attention_plain(
        q, kp, vp, tables, lens), 20, flush)
    library_ms = time_ms(torch, library, 100, flush)
    rec = {"device_ms": device_ms(torch, kernel, 50, flush),
           "library_device_ms": device_ms(torch, library, 50, flush),
           "host_us": host_us(torch, kernel)}
    el = q.element_size()
    rows = int(lens.sum())
    nbytes = (2 * q.numel() * el + tables.numel() * 4 + lens.numel() * 4
              + 2 * rows * cfg.n_kv_heads * hd * el)
    flops = 4 * rows * H * hd
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"paged_decode_attention: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, sdpa on the gathered cache {library_ms:.4f} ms (max abs "
          f"err vs plain {lib_err:.3g}), bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes} bytes, {flops} flops); " + readings(rec))
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:159",
            "launches": None, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def flash_records(torch, cfg, *, moe_grouping: bool = True):
    """Flash attention at ``cfg``'s full width (B = 1; qwen2-7b: 28 query
    heads over 4 KV heads of 128, bf16): a causal 2048-row prefill
    (timed), a ragged 2000-row one, and a 2048-row one with kv_len 1537,
    whose rows past kv_len hold finite poison; with ``moe_grouping``
    also qwen3-moe's G = 16."""
    from repro_torch.kernels import flash_attention, flash_attention_plain
    g = torch.Generator(device="cuda").manual_seed(2)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    cases = {"causal S=T=2048": (2048, None), "causal S=T=2000": (2000, None),
             "causal S=T=2048, kv_len 1537": (2048, 1537)}
    max_abs_err = 0.0
    for label, (S, kv_len) in cases.items():
        q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        if kv_len is not None:
            k[:, kv_len:], v[:, kv_len:] = 30.0, -30.0
        got = flash_attention(q, k, v, causal=True, kv_len=kv_len)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
        err = held_to_plain(torch, f"flash_attention ({label})", got, want)
        max_abs_err = max(max_abs_err, err)
        print(f"flash_attention {label} H={H} KV={KV} hd={hd} bf16: max abs "
              f"err {err:.3g}")

    # qwen3-moe's grouping, 64 query heads over 4 KV heads of 128 (G = 16:
    # all 16 rows of each warp's A fragment are heads of one group)
    from repro_torch.configs import get_config
    moe = get_config(MOE["arch"])
    S = 1000
    if moe_grouping:
        q = randn(1, S, moe.n_heads, moe.hd)
        k, v = randn(1, S, moe.n_kv_heads, moe.hd), randn(
            1, S, moe.n_kv_heads, moe.hd)
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = held_to_plain(torch, "flash_attention (G=16)", got,
                            flash_attention_plain(q, k, v, causal=True))
        max_abs_err = max(max_abs_err, err)
        print(f"flash_attention causal S=T={S} H={moe.n_heads} KV="
              f"{moe.n_kv_heads} hd={moe.hd} bf16 ({moe.name}'s grouping): "
              f"max abs err {err:.3g}")

    S = 2048
    q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
    rec = flash_timing(torch, q, k, v, causal=True,
                       want=flash_attention_plain(q, k, v, causal=True))
    ms, flops = rec["ms"], rec["flops"]
    print(f"flash_attention causal S=T={S}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {rec['plain_ms']:.4f} ms, "
          f"sdpa {rec['library_ms']:.4f} ms (max abs err vs plain "
          f"{rec['lib_err']:.3g}), bound {rec['bound_ms']:.5f} ms "
          f"({rec['bound_by']}: {rec['nbytes']} bytes, {flops} flops); "
          + readings(rec))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:85",
            "launches": None, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


def flash_timing(torch, q, k, v, *, causal: bool, want=None):
    """Time ``flash_attention`` on (q, k, v) beside its plain version and
    SDPA, and compute its bound (causal: S = T, the triangle's pairs;
    else every (query, key) pair); with no ``want`` given, first hold the
    kernel to the plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_plain
    rec = {}
    if want is None:
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=causal)
        rec["max_abs_err"] = held_to_plain(
            torch, f"flash_attention (S={q.shape[1]}, T={k.shape[1]}, "
                   f"causal={causal})", got, want)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def kernel():
        return flash_attention(q, k, v, causal=causal)

    rec["lib_err"] = float((library().transpose(1, 2).float()
                            - want.float()).abs().max())
    flush = l2_flush(torch)
    rec["ms"] = time_ms(torch, kernel, 100, flush)
    rec["plain_ms"] = time_ms(torch, lambda: flash_attention_plain(
        q, k, v, causal=causal), 10, flush)
    rec["library_ms"] = time_ms(torch, library, 100, flush)
    rec["device_ms"] = device_ms(torch, kernel, 50, flush)
    rec["library_device_ms"] = device_ms(torch, library, 50, flush)
    rec["host_us"] = host_us(torch, kernel)
    B, S, H, hd = q.shape
    T = k.shape[1]
    pairs = B * (S * (S + 1) // 2 if causal else S * T)  # pairs unmasked
    rec["nbytes"] = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rec["flops"] = 4 * pairs * H * hd          # q.k and p.v, 2 flops a MAC
    rec["bound_ms"], rec["bound_by"] = bound(rec["nbytes"], rec["flops"])
    return rec


def decode_record(torch, cfg):
    """Contiguous-cache decode at full width: B = 8 requests over a
    2048-row bf16 cache, lengths from 1 to 2048 with the rows past them
    poisoned (timed); then B = 4 at one scalar length, the shape of the
    sync engine's batched decode step; then B = 1 at length 2000, the
    shape of ``run(batch=1)``'s step (timed too)."""
    from repro_torch.kernels import decode_attention, decode_attention_plain
    g = torch.Generator(device="cuda").manual_seed(3)
    H, KV, hd, T = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 2048

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    lens_list = [2048, 1, 1537, 64, 1000, 517, 2000, 129]
    B = len(lens_list)
    q, k, v = randn(B, H, hd), randn(B, T, KV, hd), randn(B, T, KV, hd)
    for b, n in enumerate(lens_list):
        k[b, n:], v[b, n:] = 30.0, -30.0
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, lens)
    max_abs_err = held_to_plain(torch, "decode_attention", got, want)
    q4 = randn(4, H, hd)
    got4 = decode_attention(q4, k[:4], v[:4], 1025)
    torch.cuda.synchronize()
    max_abs_err = max(max_abs_err, held_to_plain(
        torch, "decode_attention (B=4, kv_len 1025)", got4,
        decode_attention_plain(q4, k[:4], v[:4], 1025)))
    print(f"decode_attention B={B} T={T} H={H} KV={KV} hd={hd} bf16, lens "
          f"{lens_list}: max abs err {max_abs_err:.3g}, poisoned rows "
          "ignored")

    k1, v1 = k[:1].clone(), v[:1].clone()
    k1[:, 2000:], v1[:, 2000:] = 30.0, -30.0
    b1 = decode_timing(torch, q[:1], k1, v1, torch.tensor(
        [2000], dtype=torch.int32, device="cuda"))
    max_abs_err = max(max_abs_err, b1["max_abs_err"])
    print(f"decode_attention B=1 kv_len 2000 (the run(batch=1) step): "
          f"max abs err {b1['max_abs_err']:.3g}; kernel {b1['ms']:.4f} ms, "
          f"plain {b1['plain_ms']:.4f} ms, sdpa {b1['library_ms']:.4f} ms "
          f"(max abs err vs plain {b1['lib_err']:.3g}), bound "
          f"{b1['bound_ms']:.5f} ms ({b1['bound_by']}: {b1['nbytes']} bytes); "
          + readings(b1))
    rec = decode_timing(torch, q, k, v, lens, want)
    print(f"decode_attention: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms (max "
          f"abs err vs plain {rec['lib_err']:.3g}), bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: {rec['nbytes']} "
          f"bytes, {rec['flops']} flops); " + readings(rec))
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:100",
            "launches": None, "max_abs_err": max_abs_err, "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


def decode_timing(torch, q, k, v, lens, want=None):
    """Time ``decode_attention`` on (q, k, v, lens) beside its plain
    version and SDPA with a length mask, and compute its bound; with no
    ``want`` given, first hold the kernel to the plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, decode_attention_plain
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rec = {}
    if want is None:
        got = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        want = decode_attention_plain(q, k, v, lens)
        rec["max_abs_err"] = held_to_plain(
            torch, f"decode_attention (B={B})", got, want)
    mask = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None, :]
    q_lib, k_lib, v_lib = q[:, :, None, :], k.transpose(1, 2), \
        v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(q_lib, k_lib, v_lib,
                                              attn_mask=mask,
                                              enable_gqa=True)

    rec["lib_err"] = float((library()[:, :, 0].float()
                            - want.float()).abs().max())
    flush = l2_flush(torch)
    rec["ms"] = time_ms(torch, lambda: decode_attention(q, k, v, lens), 100,
                        flush)
    rec["plain_ms"] = time_ms(
        torch, lambda: decode_attention_plain(q, k, v, lens), 20, flush)
    rec["library_ms"] = time_ms(torch, library, 100, flush)
    rec["device_ms"] = device_ms(
        torch, lambda: decode_attention(q, k, v, lens), 50, flush)
    rec["library_device_ms"] = device_ms(torch, library, 50, flush)
    rec["host_us"] = host_us(torch, lambda: decode_attention(q, k, v, lens))
    rows = int(lens.sum())
    el = q.element_size()
    rec["nbytes"] = 2 * q.numel() * el + B * 4 + 2 * rows * KV * hd * el
    rec["flops"] = 4 * rows * H * hd
    rec["bound_ms"], rec["bound_by"] = bound(rec["nbytes"], rec["flops"])
    return rec


# -- phase 3 --------------------------------------------------------------

def serve_trace(vocab: int):
    from repro_torch.serve import get_trace
    reqs = get_trace("shared_prefix")(SERVE["requests"], vocab,
                                      seed=SERVE["seed"],
                                      prefix_len=SERVE["prefix_len"])
    for r in reqs:
        r.n_steps = SERVE["n_steps"]
    return reqs


def new_engine(cfg, params):
    from repro_torch.serve import PagedServeEngine
    return PagedServeEngine(cfg, params, max_len=SERVE["max_len"],
                            max_batch=SERVE["max_batch"], device="cuda")


def phase_serve(torch, cfg, params):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import OK
    from repro_torch.serve.parity import NEAR_TIE, divergences

    # warm-up on a throwaway engine: cuBLAS handles, the kernel library
    warm = serve_trace(cfg.vocab_size)[:2]
    for r in warm:
        r.n_steps = 2
    new_engine(cfg, params).run(warm)

    reqs = serve_trace(cfg.vocab_size)
    eng = new_engine(cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts())
    statuses = [r.status for r in results]
    check(statuses == [OK] * len(reqs), f"statuses {statuses}")
    check(stats.tokens == SERVE["requests"] * SERVE["n_steps"],
          f"{stats.tokens} tokens emitted")
    for r in results:
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    want = cfg.n_layers * stats.decode_steps
    check(launches["paged_decode_attention"] == want,
          f"paged_decode_attention launched "
          f"{launches['paged_decode_attention']} times, want n_layers x "
          f"decode ticks = {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"PagedServeEngine {cfg.name} bf16, {len(reqs)} shared-prefix "
          f"requests x {SERVE['n_steps']} greedy tokens, page {eng.page}: "
          f"{stats.tokens} tokens in {wall:.3f} s = "
          f"{stats.tokens / wall:.1f} tok/s, {stats.ticks} ticks "
          f"({stats.decode_steps} decode, {stats.prefill_chunks} prefill "
          f"chunks), prefix hit rate {stats.prefix_hit_rate:.3f}, launches "
          f"{launches}, peak device memory {peak:.2f} GiB")

    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    paged_logit_check(torch, cfg, plain_cfg, params, reqs)

    plain = new_engine(plain_cfg, params)
    p_results, p_stats = plain.run(reqs)
    check([r.status for r in p_results] == [OK] * len(reqs),
          "plain-path replay did not finish every request OK")
    check(p_stats.ticks == stats.ticks, f"plain replay took "
          f"{p_stats.ticks} ticks, the kernel path {stats.ticks}")
    div = divergences(plain, reqs, p_results, results)
    for d in div:
        print(f"request {d['request']}: kernel and plain paths diverge at "
              f"step {d['step']}, plain top-2 margin {d['margin']}")
    check(all(d["near_tie"] for d in div),
          f"greedy streams diverge above the {NEAR_TIE} near-tie margin")
    print(f"greedy tokens: {len(reqs) - len(div)}/{len(reqs)} requests "
          f"identical to the plain path, the rest diverge at near-ties")
    return launches, reqs, results


def prefilled_slots(eng, reqs):
    """Every request's prompt prefilled into its own blocks of ``eng``'s
    pool: returns (pending tokens, tables, lens) for one decode tick."""
    import numpy as np
    B, NB = eng.max_batch, eng.nb_table
    tables = np.zeros((B, NB), np.int32)
    pend = np.zeros((B,), np.int32)
    lens = np.zeros((B,), np.int32)
    C = eng.prefill_chunk
    for b, r in enumerate(reqs[:B]):
        s = r.prompt.shape[0]
        tables[b, :math.ceil(s / eng.page)] = \
            1 + b * NB + np.arange(math.ceil(s / eng.page))
        for pos in range(0, s, C):
            nv = min(C, s - pos)
            toks = np.zeros((1, C), np.int32)
            toks[0, :nv] = r.prompt[pos:pos + nv]
            logits = eng.prefill(toks, tables[b:b + 1], pos, nv)
        pend[b] = int(logits.argmax())
        lens[b] = s
    return pend, tables, lens


def logit_check(torch, label: str, cfg, plain_cfg, params, state, step, *,
                limit=LOGIT_REL_TOL, yardstick: bool = True):
    """One step on identical copies of ``state`` (a pool or cache pytree)
    through the kernel path and the plain path; ``step(cfg, params,
    state)`` returns the logits.  Relative error is ||a - b|| / ||b||
    over all logits, held below ``limit`` (None: printed only).  With
    ``yardstick`` the plain path also runs in float32 (weights and state
    upcast), the yardstick of what the working type's rounding alone
    costs, and the kernel path may be no further from it than 1.5x the
    plain path."""
    from repro_torch.models.layers import DTYPES
    out = {}
    runs = [("kernel", cfg), ("plain", plain_cfg)]
    if yardstick:
        runs.append(("f32", dataclasses.replace(plain_cfg, dtype="float32")))
    for name, c in runs:
        st = _map(lambda t: t.clone().to(DTYPES[c.dtype]), state)
        p = params if c.dtype == cfg.dtype else _map(
            lambda t: t.to(DTYPES[c.dtype]), params)
        out[name] = step(c, p, st).float()
        del p, st
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(out["kernel"]).all()), "non-finite logits")

    def rel(a, b):
        return float((out[a] - out[b]).norm() / out[b].norm())

    r = rel("kernel", "plain")
    r_max = float((out["kernel"] - out["plain"]).abs().max()
                  / out["plain"].abs().max())
    msg = (f"{label} logits ({cfg.dtype}) on identical state: kernel vs "
           f"plain path relative error {r:.3g} (limit {limit}; max-abs ratio "
           f"{r_max:.3g})")
    if yardstick:
        rk, rp = rel("kernel", "f32"), rel("plain", "f32")
        msg += f"; against float32: kernel path {rk:.3g}, plain path {rp:.3g}"
    print(msg)
    if limit is not None:
        check(r < limit, f"{label} logits: kernel vs plain path relative "
              f"error {r:.3g} >= {limit}")
    if yardstick:
        check(rk <= 1.5 * rp, f"{label}: the kernel path is further from "
              f"float32 ({rk:.3g}) than 1.5x the plain path ({rp:.3g})")


def streams_check(torch, eng, plain, reqs, results, *, enforce=True):
    """Greedy streams of ``eng`` against ``plain``'s replay of ``reqs``:
    each may first differ only at a near-tie (``enforce``; else the
    divergences are printed only)."""
    from repro_torch.serve.parity import NEAR_TIE, divergences
    p_results, _ = plain.run(reqs)
    div = divergences(plain, reqs, p_results, results)
    for d in div:
        print(f"request {d['request']}: kernel and plain paths diverge at "
              f"step {d['step']}, plain top-2 margin {d['margin']}")
    n_tie = sum(d["near_tie"] for d in div)
    print(f"greedy tokens ({eng.cfg.dtype}): {len(reqs) - len(div)}/"
          f"{len(reqs)} requests identical to the plain path, {n_tie} "
          f"diverge at near-ties (top-2 margin < {NEAR_TIE}), "
          f"{len(div) - n_tie} above")
    if enforce:
        check_later(n_tie == len(div), f"{eng.cfg.name}: greedy streams "
                    f"diverge above the {NEAR_TIE} near-tie margin")


def paged_logit_check(torch, cfg, plain_cfg, params, reqs):
    from repro_torch.models import paged_decode_step
    eng = new_engine(cfg, params)
    pend, tables, lens = prefilled_slots(eng, reqs)
    args = [torch.tensor(a, device="cuda")
            for a in (pend[:, None], tables, lens)]
    logit_check(torch, "paged decode tick", cfg, plain_cfg, params,
                eng.cache.pools,
                lambda c, p, pools: paged_decode_step(c, p, pools, *args))


# -- phase 4 --------------------------------------------------------------

def sync_workload(vocab: int):
    """The sync phase's requests and its batch, drawn from the seed."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SYNC["seed"])
    reqs = [Request(prompt=rng.integers(0, vocab, s).astype(np.int32),
                    n_steps=SYNC["n_steps"]) for s in SYNC["prompts"]]
    batch = rng.integers(0, vocab, (SYNC["batch"], SYNC["batch_len"])
                         ).astype(np.int32)
    return reqs, batch


def phase_sync_serve(torch, cfg, params):
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, max_len=SYNC["max_len"], device="cuda")
    eng.generate(np.arange(16, dtype=np.int32)[None], n_steps=2)   # warm-up
    reqs, batch = sync_workload(cfg.vocab_size)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    t1 = time.perf_counter()
    gen = eng.generate(batch, n_steps=SYNC["n_steps"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(launch_counts())
    prefills = len(reqs) + 1
    steps = stats.decode_steps + gen.steps
    check_sync_launches(cfg, launches, prefills, steps)
    for r in results:
        check(len(r.tokens) == SYNC["n_steps"], f"{len(r.tokens)} tokens")
    for toks in [r.tokens for r in results] + [gen.tokens]:
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    check(gen.tokens.shape == (SYNC["batch"], SYNC["n_steps"]),
          f"generate returned {gen.tokens.shape}")
    n_run = sum(len(r.tokens) for r in results)
    print(f"ServeEngine {cfg.name} bf16, max_len {SYNC['max_len']}: "
          f"run(batch=1) of prompts {list(SYNC['prompts'])} x "
          f"{SYNC['n_steps']} greedy tokens in {t1 - t0:.3f} s "
          f"({n_run / (t1 - t0):.1f} tok/s); generate of {SYNC['batch']} x "
          f"{SYNC['batch_len']}-token prompts x {SYNC['n_steps']} tokens in "
          f"{t2 - t1:.3f} s ({gen.tokens.size / (t2 - t1):.1f} tok/s); "
          f"{prefills} prefills, {steps} decode steps, launches {launches}")

    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    prompt = reqs[0].prompt[None]
    logits, cache = eng.prefill(prompt)
    tok = logits.argmax(-1)[:, None]
    logit_check(torch, f"sync decode step at position {prompt.shape[1]}",
                cfg, plain_cfg, params, cache,
                lambda c, p, cc: decode_step(c, p, cc, tok,
                                             prompt.shape[1])[0])
    del cache

    streams_check(torch, eng, ServeEngine(
        plain_cfg, params, max_len=SYNC["max_len"], device="cuda"),
        reqs, results)
    return launches


# -- phase 5 --------------------------------------------------------------

def phase_engines(torch, cfg, params, reqs, paged_results):
    """The sync engine (the greedy oracle) replays the paged phase's
    trace; the paged engine's streams may differ only at near-ties."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.parity import NEAR_TIE, divergences
    sync = ServeEngine(cfg, params, max_len=SERVE["max_len"], device="cuda")
    s_results, _ = sync.run(reqs)
    div = divergences(sync, reqs, s_results, paged_results)
    for d in div:
        print(f"request {d['request']}: sync and paged engines diverge at "
              f"step {d['step']}, sync top-2 margin {d['margin']}")
    check(all(d["near_tie"] for d in div), f"sync and paged engines "
          f"diverge above the {NEAR_TIE} near-tie margin")
    print(f"sync vs paged engine on the {len(reqs)}-request shared-prefix "
          f"trace: {len(reqs) - len(div)}/{len(reqs)} greedy streams "
          f"identical, the rest diverge at near-ties")


# -- phase 6 --------------------------------------------------------------


def profile(torch, label: str, fn, n_wall: int = 5, parts=None):
    """Host wall time of ``fn`` (mean of ``n_wall`` calls, each ending in
    a synchronize, no profiler attached) against the device time of its
    kernels in one profiled call: the share of a step the card is busy.
    ``parts`` maps a name to the CUDA kernels (substrings of their names)
    that make it up; each part's device time and share is printed.
    Returns ``{"wall_ms", "device_ms"}`` (``device_ms`` None when the
    profiler recorded no kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_wall):
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_wall
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev = sum(e.self_device_time_total for e in kernels) / 1e3
    if dev <= 0:
        print(f"{label}: wall {wall:.3f} ms, device time not measured "
              "(the profiler recorded no kernels)")
        return {"wall_ms": wall, "device_ms": None}
    print(f"{label}: wall {wall:.3f} ms, device kernels {dev:.3f} ms in "
          f"{sum(e.count for e in kernels)} launches (busy "
          f"{100 * dev / wall:.1f}%, idle {100 - 100 * dev / wall:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    for name, keys in (parts or {}).items():
        mine = [e for e in kernels if any(k in e.key for k in keys)]
        t = sum(e.self_device_time_total for e in mine) / 1e3
        print(f"  {name}: {t:.4f} ms of device time in "
              f"{sum(e.count for e in mine)} kernels "
              f"({100 * t / dev:.1f}% of the step's)")
    return {"wall_ms": wall, "device_ms": dev}


def phase_profile(torch, cfg, params, reqs):
    import numpy as np
    eng = new_engine(cfg, params)
    pend, tables, lens = prefilled_slots(eng, reqs)
    profile(torch, f"paged decode tick (B={eng.max_batch}, lens "
                   f"{int(lens.min())}..{int(lens.max())})",
            lambda: eng.decode(pend, tables, lens).argmax(-1).cpu())
    toks = np.zeros((1, eng.prefill_chunk), np.int32)
    profile(torch, f"paged prefill chunk ({eng.prefill_chunk} rows)",
            lambda: eng.prefill(toks, tables[:1], 0, eng.prefill_chunk)
            .argmax().cpu())
    del eng


def phase_sync_profile(torch, cfg, params):
    """Profiles the sync prefill and decode step on the kernel path;
    returns their readings (``profile``'s), which phase 22 prices."""
    import numpy as np
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, max_len=SYNC["max_len"], device="cuda")
    rng = np.random.default_rng(SYNC["seed"] + 1)
    prompt = rng.integers(0, cfg.vocab_size, (1, SYNC["max_len"])
                          ).astype(np.int32)
    out = {"prefill": profile(
        torch, f"sync prefill ({SYNC['max_len']} rows)",
        lambda: eng.prefill(prompt)[0].argmax(-1).cpu())}
    _, batch = sync_workload(cfg.vocab_size)
    logits, cache = eng.prefill(batch)
    tok = logits.argmax(-1)[:, None]
    pos = batch.shape[1]
    out["decode"] = profile(
        torch, f"sync decode step (B={batch.shape[0]}, position {pos})",
        lambda: eng.decode(cache, tok, pos).argmax(-1).cpu())
    check(tuple(prompt.shape) == (PERF["prefill"]["B"], PERF["prefill"]["S"])
          and (batch.shape[0], pos) == (PERF["decode"]["B"],
                                        PERF["decode"]["pos"]),
          f"phase 6's steps (prefill {prompt.shape}, decode B="
          f"{batch.shape[0]} at {pos}) are not the ones phase 22 prices "
          f"({PERF})")
    return out


# -- phase 7: the MoE grouped GEMM ------------------------------------------

def moe_gmm_record(torch, cfg, cases=None, seed: int = 4):
    """``moe_gmm`` at ``cfg``'s full width (bf16) at the shapes its MoE
    layers give it, by default qwen3-moe's (E = 128 experts): a paged
    decode tick's gate/up and down products (8 slots x capacity 4 = 32
    rows an expert), a 2000-row sync prefill's gate/up (capacity 160),
    and a ragged case (C = 44, N = 1000); ``cases`` maps a label to
    (C, K, N, timed).  Each is held to the plain version; the timed ones
    beside ``torch.bmm`` and their bound.  The record is the first timed
    case's, with every timed case under ``shapes``."""
    from repro_torch.kernels import moe_gmm, moe_gmm_plain
    g = torch.Generator(device="cuda").manual_seed(seed)
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    if cases is None:
        cases = {"decode gate/up": (32, D, F, True),
                 "decode down": (32, F, D, True),
                 "prefill gate/up (S = 2000)": (160, D, F, True),
                 "ragged C = 44, N = 1000": (44, D, 1000, False)}
    flush = l2_flush(torch)
    record, max_abs_err, shapes = None, 0.0, []
    for label, (C, K, N, timed) in cases.items():
        x = torch.randn((E, C, K), generator=g, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((E, K, N), generator=g, device="cuda")
             / math.sqrt(K)).to(torch.bfloat16)
        got = moe_gmm(x, w)
        torch.cuda.synchronize()
        want = moe_gmm_plain(x, w)
        err = held_to_plain(torch, f"moe_gmm ({label})", got, want)
        max_abs_err = max(max_abs_err, err)
        same = float((got == want).float().mean())
        msg = (f"moe_gmm {label}: E={E} C={C} K={K} N={N} bf16: max abs err "
               f"{err:.3g}, {same:.6f} of outputs equal to the plain "
               "version's (an f32 sum rounded once)")
        if timed:
            ms = time_ms(torch, lambda: moe_gmm(x, w), 50, flush)
            plain_ms = time_ms(torch, lambda: moe_gmm_plain(x, w), 10, flush)
            library_ms = time_ms(torch, lambda: torch.bmm(x, w), 50, flush)
            rec = {"device_ms": device_ms(torch, lambda: moe_gmm(x, w), 20,
                                          flush),
                   "library_device_ms": device_ms(
                       torch, lambda: torch.bmm(x, w), 20, flush),
                   "host_us": host_us(torch, lambda: moe_gmm(x, w), 50)}
            lib_err = float((torch.bmm(x, w).float() - want.float()).abs()
                            .max())
            nbytes = (x.numel() + w.numel() + E * C * N) * x.element_size()
            flops = 2 * E * C * K * N
            bound_ms, bound_by = bound(nbytes, flops)
            msg += (f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                    f"{nbytes / ms / 1e9:.3f} TB/s), plain {plain_ms:.4f} ms, "
                    f"torch.bmm {library_ms:.4f} ms (max abs err vs plain "
                    f"{lib_err:.3g}), bound {bound_ms:.5f} ms ({bound_by}: "
                    f"{nbytes} bytes, {flops} flops); "
                    + readings(rec, library="torch.bmm"))
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
            shapes.append(dict(row, shape=f"{cfg.name} {label}: E={E} C={C} "
                               f"K={K} N={N}", max_abs_err=err))
            if record is None:              # the decode tick's shape
                record = dict({"name": "moe_gmm", "route": "cuda",
                               "source": "src/repro_torch/csrc/moe_gmm.cu",
                               "replaces": "src/repro/kernels/moe_gmm.py:42",
                               "launches": None}, **row)
        print(msg)
        del x, w, got, want
    torch.cuda.empty_cache()
    record["max_abs_err"] = max_abs_err
    record["shapes"] = shapes
    return record


# -- phases 8-10: qwen3-moe at full width, cut in depth ---------------------

def moe_logit_check(torch, label, cfg, plain_cfg, params, state, step):
    """One decode step on identical copies of ``state`` through the
    kernel and the plain path, with the routing of every layer logged.
    The step's rows are independent (one group each), so each row's
    first layer whose top-k set differs is where its routing flipped:
    the plain path's top-k / top-(k+1) margin there must be below
    ``ROUTING_MARGIN`` (a near-tie), and the rows that never flipped
    must meet the ``LOGIT_REL_TOL`` relative error.  (No float32
    yardstick here: a float32 copy of the weights would not fit.)"""
    from repro_torch.serve.parity import routing_differences, routing_log
    out, logs = {}, {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        st = _map(lambda t: t.clone(), state)
        with routing_log() as log:
            out[name] = step(c, params, st).float()
        logs[name] = log
        del st
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(out["kernel"]).all()), "non-finite logits")
    rows = out["kernel"].shape[0]
    first = {}                               # row -> (layer, margin)
    n_pairs = 0
    for layer, diff in routing_differences(cfg.moe.top_k, logs["kernel"],
                                           logs["plain"]):
        n_pairs += len(diff)
        for r, m in diff:
            first.setdefault(r, (layer, m))
    same = [r for r in range(rows) if r not in first]
    print(f"{label}: {n_pairs} of {rows * len(logs['plain'])} (token, "
          f"layer) pairs route to different top-{cfg.moe.top_k} sets on the "
          f"two paths; {len(first)} of {rows} tokens flip somewhere")
    for r, (layer, m) in sorted(first.items()):
        print(f"  token {r}: first differs at layer {layer}, plain top-"
              f"{cfg.moe.top_k}/top-{cfg.moe.top_k + 1} margin {m:.3g}")
        check(m < ROUTING_MARGIN, f"{label}: token {r} routes differently "
              f"at layer {layer} with a plain-path margin {m:.3g} >= "
              f"{ROUTING_MARGIN}: not a routing near-tie")
    if first:
        smallest = min(m for _, m in first.values())
        print(f"  case: routing near-ties (smallest margin {smallest:.3g}"
              f" < {ROUTING_MARGIN}); the relative-error limit holds over "
              f"the {len(same)} tokens that never flipped")
    else:
        print("  case: every top-k set identical; the relative-error limit "
              "holds over every token")
    if same:
        k, p = out["kernel"][same], out["plain"][same]
        r = float((k - p).norm() / p.norm())
        print(f"  logits of the {len(same)} unflipped tokens: kernel vs "
              f"plain relative error {r:.3g} (limit {LOGIT_REL_TOL})")
        check(r < LOGIT_REL_TOL, f"{label} logits: kernel vs plain path "
              f"relative error {r:.3g} >= {LOGIT_REL_TOL}")
    return {"pairs": n_pairs, "flipped": len(first),
            "margin": min((m for _, m in first.values()), default=None)}


def moe_streams_check(kernel, plain, reqs, p_results, results, *,
                      later: bool = False):
    """Greedy streams of the kernel path against the plain path's: a
    stream may first differ at a logit near-tie or at a routing near-tie
    (``repro_torch.serve.parity``, margin ``ROUTING_MARGIN``)."""
    from repro_torch.serve.parity import NEAR_TIE, divergences
    div = divergences(plain, reqs, p_results, results, engine=kernel,
                      routing_margin=ROUTING_MARGIN)
    for d in div:
        why = f"top-2 logit margin {d['margin']}"
        if "routing" in d:
            why += f" >= {NEAR_TIE}; first routing difference {d['routing']}"
        print(f"request {d['request']}: kernel and plain paths diverge at "
              f"step {d['step']}, {why}")
    (check_later if later else check)(
        all(d["near_tie"] for d in div), f"{kernel.cfg.name}: greedy "
        f"streams diverge above the {NEAR_TIE} logit and the "
        f"{ROUTING_MARGIN} routing near-tie margins")
    print(f"greedy tokens: {len(reqs) - len(div)}/{len(reqs)} requests "
          f"identical to the plain path, the rest diverge at near-ties")


def phase_moe_serve(torch, cfg, params):
    """The paged engine serves the shared-prefix trace on the MoE model."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import paged_decode_step
    from repro_torch.serve import OK
    warm = serve_trace(cfg.vocab_size)[:2]
    for r in warm:
        r.n_steps = 2
    new_engine(cfg, params).run(warm)

    reqs = serve_trace(cfg.vocab_size)
    eng = new_engine(cfg, params)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts())
    check([r.status for r in results] == [OK] * len(reqs),
          f"statuses {[r.status for r in results]}")
    for r in results:
        check(len(r.tokens) == SERVE["n_steps"], f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    L = cfg.n_layers
    for name, want, per in (
            ("paged_decode_attention", L * stats.decode_steps,
             "n_layers x decode ticks"),
            ("moe_gmm", 3 * L * (stats.decode_steps + stats.prefill_chunks),
             "3 x n_layers x (decode ticks + prefill chunks)")):
        check(launches[name] == want, f"{name} launched {launches[name]} "
              f"times, want {per} = {want}")
    print(f"PagedServeEngine {cfg.name} ({L} layers) bf16, {len(reqs)} "
          f"shared-prefix requests x {SERVE['n_steps']} greedy tokens: "
          f"{stats.tokens} tokens in {wall:.3f} s = "
          f"{stats.tokens / wall:.1f} tok/s, {stats.ticks} ticks "
          f"({stats.decode_steps} decode, {stats.prefill_chunks} prefill "
          f"chunks), prefix hit rate {stats.prefix_hit_rate:.3f}, launches "
          f"{launches}")

    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    probe = new_engine(cfg, params)
    pend, tables, lens = prefilled_slots(probe, reqs)
    args = [torch.tensor(a, device="cuda")
            for a in (pend[:, None], tables, lens)]
    routing = moe_logit_check(
        torch, "MoE paged decode tick", cfg, plain_cfg, params,
        probe.cache.pools,
        lambda c, p, pools: paged_decode_step(c, p, pools, *args))
    del probe

    plain = new_engine(plain_cfg, params)
    p_results, p_stats = plain.run(reqs)
    check([r.status for r in p_results] == [OK] * len(reqs),
          "plain-path replay did not finish every request OK")
    check(p_stats.ticks == stats.ticks, f"plain replay took "
          f"{p_stats.ticks} ticks, the kernel path {stats.ticks}")
    moe_streams_check(eng, plain, reqs, p_results, results)
    return launches, routing


def phase_moe_sync(torch, cfg, params):
    """The sync engine serves two long prompts one at a time on the MoE
    model; one decode step of a batch is checked against the plain path."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, max_len=MOE_SYNC["max_len"], device="cuda")
    eng.generate(np.arange(16, dtype=np.int32)[None], n_steps=2)   # warm-up
    rng = np.random.default_rng(MOE_SYNC["seed"])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, s)
                    .astype(np.int32), n_steps=MOE_SYNC["n_steps"])
            for s in MOE_SYNC["prompts"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts())
    L, prefills, steps = cfg.n_layers, len(reqs), stats.decode_steps
    check_sync_launches(cfg, launches, prefills, steps)
    for r in results:
        check(len(r.tokens) == MOE_SYNC["n_steps"], f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    n_run = sum(len(r.tokens) for r in results)
    print(f"ServeEngine {cfg.name} ({L} layers) bf16, max_len "
          f"{MOE_SYNC['max_len']}: run(batch=1) of prompts "
          f"{list(MOE_SYNC['prompts'])} x {MOE_SYNC['n_steps']} greedy tokens "
          f"in {wall:.3f} s ({n_run / wall:.1f} tok/s); {prefills} prefills, "
          f"{steps} decode steps, launches {launches}")

    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    batch = rng.integers(0, cfg.vocab_size, MOE_SYNC["check_batch"]
                         ).astype(np.int32)
    logits, cache = eng.prefill(batch)
    tok = logits.argmax(-1)[:, None]
    pos = batch.shape[1]
    routing = moe_logit_check(
        torch, f"MoE sync decode step (B={batch.shape[0]}, position {pos})",
        cfg, plain_cfg, params, cache,
        lambda c, p, cc: decode_step(c, p, cc, tok, pos)[0])
    del cache

    plain = ServeEngine(plain_cfg, params, max_len=MOE_SYNC["max_len"],
                        device="cuda")
    p_results, _ = plain.run(reqs)
    moe_streams_check(eng, plain, reqs, p_results, results)
    return launches, routing


def phase_moe_profile(torch, cfg, params):
    import numpy as np
    from repro_torch.serve import ServeEngine
    eng = new_engine(cfg, params)
    pend, tables, lens = prefilled_slots(eng, serve_trace(cfg.vocab_size))
    profile(torch, f"MoE paged decode tick (B={eng.max_batch}, lens "
                   f"{int(lens.min())}..{int(lens.max())})",
            lambda: eng.decode(pend, tables, lens).argmax(-1).cpu())
    del eng
    sync = ServeEngine(cfg, params, max_len=MOE_SYNC["max_len"],
                       device="cuda")
    batch = np.random.default_rng(MOE_SYNC["seed"] + 1).integers(
        0, cfg.vocab_size, MOE_SYNC["check_batch"]).astype(np.int32)
    logits, cache = sync.prefill(batch)
    tok = logits.argmax(-1)[:, None]
    pos = batch.shape[1]
    profile(torch, f"MoE sync decode step (B={batch.shape[0]}, position "
                   f"{pos})",
            lambda: sync.decode(cache, tok, pos).argmax(-1).cpu())


# -- phase 11: the SSD scan ---------------------------------------------------

def ssd_work(B: int, S: int, nh: int, hd: int, G: int, ds: int, chunk: int,
             el: int):
    """(bytes, flops) of one SSD scan: x, dt, A, B and C read once, y and
    the f32 state written once (``el`` bytes per x, B, C and y element);
    the products of the kernel's algorithm at its chunk, over causal
    (i, j) pairs only and the scores once per group: per chunk of n rows
    2 ds n(n+1)/2 per group, and 2 hd n(n+1)/2 + 2 n ds hd (y) + 2 n ds hd
    (state) per head."""
    nbytes = (2 * B * S * nh * hd + 2 * B * S * G * ds) * el \
        + B * S * nh * 4 + nh * 4 + B * nh * hd * ds * 4
    flops = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        pairs = n * (n + 1) // 2
        flops += B * (G * 2 * ds * pairs
                      + nh * (2 * hd * pairs + 4 * n * ds * hd))
    return nbytes, flops


def ssd_record(torch):
    """``mamba2_ssd`` at the serving path's shapes (B = 1, head dim 64,
    one B/C group, bf16; dt a softplus, A the initial -1..-16): mamba2's
    32 heads with d_state 128 over a 2048-row prefill (timed) and a
    ragged 2000-row one, jamba's 128 heads with d_state 16 over 2000 rows
    (timed).  Output and final state are held to the plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import mamba2_ssd, mamba2_ssd_plain
    from repro_torch.kernels.mamba2_ssd import CHUNK
    g = torch.Generator(device="cuda").manual_seed(7)
    cases = {"mamba2 prefill S=2048": (2048, 32, 128, True),
             "mamba2 ragged S=2000": (2000, 32, 128, False),
             "jamba S=2000": (2000, 128, 16, True)}
    flush = l2_flush(torch)
    record, max_abs_err = None, 0.0
    for label, (S, nh, ds, timed) in cases.items():
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        x = (randn(1, S, nh, 64) * 0.5).to(torch.bfloat16)
        dt = F.softplus(randn(1, S, nh))
        A = -torch.linspace(1.0, 16.0, nh, device="cuda")
        Bm = (randn(1, S, 1, ds) * 0.5).to(torch.bfloat16)
        Cm = (randn(1, S, 1, ds) * 0.5).to(torch.bfloat16)
        y, h = mamba2_ssd(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
        want_y, want_h = mamba2_ssd_plain(x, dt, A, Bm, Cm)
        err = max(held_to_plain(torch, f"mamba2_ssd y ({label})", y, want_y),
                  held_to_plain(torch, f"mamba2_ssd state ({label})", h,
                                want_h))
        max_abs_err = max(max_abs_err, err)
        msg = (f"mamba2_ssd {label}: nh={nh} hd=64 ds={ds} G=1 bf16: max abs "
               f"err {err:.3g} (y up to {float(want_y.float().abs().max()):.3g})")
        if timed:
            ms = time_ms(torch, lambda: mamba2_ssd(x, dt, A, Bm, Cm), 20,
                         flush)
            plain_ms = time_ms(torch, lambda: mamba2_ssd_plain(
                x, dt, A, Bm, Cm), 5, flush)
            nbytes, flops = ssd_work(1, S, nh, 64, 1, ds, CHUNK, 2)
            bound_ms, bound_by = bound(nbytes, flops)
            dev = device_ms(torch, lambda: mamba2_ssd(x, dt, A, Bm, Cm), 20,
                            flush)
            host = host_us(torch, lambda: mamba2_ssd(x, dt, A, Bm, Cm), 50)
            msg += (f"; kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s, "
                    f"{flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} "
                    f"ms, no library call, bound {bound_ms:.5f} ms "
                    f"({bound_by}: {nbytes} bytes, {flops} flops at chunk "
                    f"{CHUNK}); device "
                    + ("not measured" if dev is None else f"{dev:.4f} ms")
                    + f" (profiler, its {len(SSD_KERNELS)} CUDA kernels), "
                    f"wrapper host time {host:.1f} us per call")
            if record is None:              # mamba2's prefill shape
                record = {"name": "mamba2_ssd", "route": "cuda",
                          "source": "src/repro_torch/csrc/mamba2_ssd.cu",
                          "replaces": "src/repro/kernels/mamba2_ssd.py:75",
                          "launches": None, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": None}
        print(msg)
        del x, dt, Bm, Cm, y, h, want_y, want_h
    torch.cuda.empty_cache()
    record["max_abs_err"] = max_abs_err
    return record


# -- phases 12-14: mamba2-370m and jamba-v0.1-52b through the sync engine ----

def n_ssm_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))


def check_sync_launches(cfg, launches, prefills: int, steps: int) -> None:
    """The sync path's launch counts: ``mamba2_ssd`` twice per SSM layer
    per prefill, flash once per attention layer (self or cross, and each
    encoder layer) per prefill, decode once per attention layer per
    decode step, ``moe_gmm`` three times per MoE layer per step.  MLA
    layers launch no attention kernel: their value head differs from
    their query head, which no kernel takes (the reference's dispatch
    gives them its plain path too)."""
    n_ssm = n_ssm_layers(cfg)
    n_attn = 0 if cfg.mla else cfg.n_layers - n_ssm
    n_enc = cfg.encoder.n_layers if cfg.encoder else 0
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    for name, want, per in (
            ("mamba2_ssd", 2 * n_ssm * prefills,
             f"2 x {n_ssm} SSM layers x {prefills} prefills"),
            ("flash_attention", (n_attn + n_enc) * prefills,
             f"({n_attn} attention + {n_enc} encoder layers) x {prefills} "
             "prefills"),
            ("decode_attention", n_attn * steps,
             f"{n_attn} attention layers x {steps} decode steps"),
            ("moe_gmm", 3 * n_moe * (prefills + steps),
             f"3 x {n_moe} MoE layers x {prefills + steps} steps")):
        check(launches[name] == want, f"{name} launched {launches[name]} "
              f"times, want {per} = {want}")


def handoff_check(torch, cfg, params, prompt, *, limit=HANDOFF_TOL):
    """State handoff on the kernel path: ``decode_step`` of token S - 1
    after ``prefill`` of the first S - 1 tokens against ``forward``'s
    logits at S, elementwise within ``limit`` + ``limit`` |x| (None:
    printed only); the plain path's handoff error is printed beside it."""
    from repro_torch.models import decode_step, forward, prefill
    S = prompt.shape[0]
    toks = torch.tensor(prompt[None], dtype=torch.int32, device="cuda")
    errs = {}
    for name, c in (("kernel", cfg),
                    ("plain", dataclasses.replace(cfg, use_kernels=False))):
        full = forward(c, params, {"tokens": toks}, mode="train")[0][:, -1]
        _, cache = prefill(c, params, {"tokens": toks[:, :-1]}, max_len=S)
        step = decode_step(c, params, cache, toks[:, -1:], S - 1)[0][:, 0]
        tol = 0.0 if limit is None else limit
        bad = (step - full).abs() > tol + tol * full.abs()
        errs[name] = (float((step - full).norm() / full.norm()),
                      float((step - full).abs().max()), int(bad.sum()))
        del full, cache, step
    print(f"state handoff ({cfg.dtype}) at S={S}, decode after a prefill of "
          f"S-1 against forward: kernel path relative error "
          f"{errs['kernel'][0]:.3g}, max abs {errs['kernel'][1]:.3g}; plain "
          f"path {errs['plain'][0]:.3g}, {errs['plain'][1]:.3g} (limit "
          f"{limit} + {limit} |x|)")
    if limit is not None:
        check(errs["kernel"][2] == 0, f"state handoff: {errs['kernel'][2]} "
              f"logits outside {limit} + {limit} |x|")


def phase_ssm_sync(torch, cfg, params):
    """mamba2-370m through the sync engine: the run, launch counts,
    prefill and decode-step logits, the state handoff and the streams."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, params, max_len=SSM_SYNC["max_len"], device="cuda")
    eng.generate(np.arange(16, dtype=np.int32)[None], n_steps=2)   # warm-up
    rng = np.random.default_rng(SSM_SYNC["seed"])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, s)
                    .astype(np.int32), n_steps=SSM_SYNC["n_steps"])
            for s in SSM_SYNC["prompts"]]
    batch = rng.integers(0, cfg.vocab_size, (SSM_SYNC["batch"],
                                             SSM_SYNC["batch_len"])
                         ).astype(np.int32)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    t1 = time.perf_counter()
    gen = eng.generate(batch, n_steps=SSM_SYNC["n_steps"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(launch_counts())
    prefills = len(reqs) + 1
    steps = stats.decode_steps + gen.steps
    check_sync_launches(cfg, launches, prefills, steps)
    for r in results:
        check(len(r.tokens) == SSM_SYNC["n_steps"], f"{len(r.tokens)} tokens")
    check(gen.tokens.shape == (SSM_SYNC["batch"], SSM_SYNC["n_steps"]),
          f"generate returned {gen.tokens.shape}")
    for toks in [r.tokens for r in results] + [gen.tokens]:
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    n_run = sum(len(r.tokens) for r in results)
    print(f"ServeEngine {cfg.name} bf16, max_len {SSM_SYNC['max_len']}: "
          f"run(batch=1) of prompts {list(SSM_SYNC['prompts'])} x "
          f"{SSM_SYNC['n_steps']} greedy tokens in {t1 - t0:.3f} s "
          f"({n_run / (t1 - t0):.1f} tok/s); generate of {SSM_SYNC['batch']}"
          f" x {SSM_SYNC['batch_len']}-token prompts x {SSM_SYNC['n_steps']} "
          f"tokens in {t2 - t1:.3f} s ({gen.tokens.size / (t2 - t1):.1f} "
          f"tok/s); {prefills} prefills, {steps} decode steps, launches "
          f"{launches}")

    # bf16: 48 random-weight SSM layers amplify rounding far past the
    # 2e-2 logit, 3e-2 handoff and 0.05 near-tie limits (the plain path's
    # own bf16 logits lie ~30% from its float32 ones), so in bf16 the
    # kernel path is held to the float32 yardstick only; the limits hold
    # the same model in float32 (weights upcast, ~1.5 GB), where the
    # kernel and plain paths differ by f32 rounding
    prompt = reqs[0].prompt[None]
    toks = torch.tensor(prompt, dtype=torch.int32, device="cuda")
    p32 = _map(lambda t: t.float(), params)
    for c, p, limit in ((cfg, params, None),
                        (dataclasses.replace(cfg, dtype="float32"), p32,
                         LOGIT_REL_TOL)):
        plain_c = dataclasses.replace(c, use_kernels=False)
        e = ServeEngine(c, p, max_len=SSM_SYNC["max_len"], device="cuda")
        logit_check(torch, f"sync prefill of {prompt.shape[1]} tokens", c,
                    plain_c, p, {},
                    lambda cc, pp, _: prefill(cc, pp, {"tokens": toks},
                                              SSM_SYNC["max_len"])[0],
                    limit=limit, yardstick=limit is None)
        logits, cache = e.prefill(prompt)
        tok = logits.argmax(-1)[:, None]
        logit_check(torch, f"sync decode step at position {prompt.shape[1]}",
                    c, plain_c, p, cache,
                    lambda cc, pp, st: decode_step(cc, pp, st, tok,
                                                   prompt.shape[1])[0],
                    limit=limit, yardstick=limit is None)
        del cache
        handoff_check(torch, c, p, reqs[1].prompt,
                      limit=None if limit is None else HANDOFF_TOL)
        if limit is None:
            streams_check(torch, eng, ServeEngine(
                plain_c, p, max_len=SSM_SYNC["max_len"], device="cuda"),
                reqs, results, enforce=False)
        else:
            results32, _ = e.run(reqs)
            streams_check(torch, e, ServeEngine(
                plain_c, p, max_len=SSM_SYNC["max_len"], device="cuda"),
                reqs, results32)
        del e
    del p32
    torch.cuda.empty_cache()
    return launches


def phase_hybrid_sync(torch, cfg, params):
    """jamba (one period) through the sync engine: the run, launch counts,
    a decode step's logits and routing, and the streams."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, max_len=HYBRID_SYNC["max_len"],
                      device="cuda")
    eng.generate(np.arange(16, dtype=np.int32)[None], n_steps=2)   # warm-up
    rng = np.random.default_rng(HYBRID_SYNC["seed"])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, s)
                    .astype(np.int32), n_steps=HYBRID_SYNC["n_steps"])
            for s in HYBRID_SYNC["prompts"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts())
    check_sync_launches(cfg, launches, len(reqs), stats.decode_steps)
    for r in results:
        check(len(r.tokens) == HYBRID_SYNC["n_steps"],
              f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    n_run = sum(len(r.tokens) for r in results)
    print(f"ServeEngine {cfg.name} ({cfg.n_layers} layers) bf16, max_len "
          f"{HYBRID_SYNC['max_len']}: run(batch=1) of prompts "
          f"{list(HYBRID_SYNC['prompts'])} x {HYBRID_SYNC['n_steps']} greedy "
          f"tokens in {wall:.3f} s ({n_run / wall:.1f} tok/s); {len(reqs)} "
          f"prefills, {stats.decode_steps} decode steps, launches {launches}")

    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    batch = rng.integers(0, cfg.vocab_size, HYBRID_SYNC["check_batch"]
                         ).astype(np.int32)
    logits, cache = eng.prefill(batch)
    tok = logits.argmax(-1)[:, None]
    pos = batch.shape[1]
    routing = moe_logit_check(
        torch, f"hybrid sync decode step (B={batch.shape[0]}, position "
               f"{pos})", cfg, plain_cfg, params, cache,
        lambda c, p, cc: decode_step(c, p, cc, tok, pos)[0])
    del cache
    plain = ServeEngine(plain_cfg, params, max_len=HYBRID_SYNC["max_len"],
                        device="cuda")
    p_results, _ = plain.run(reqs)
    moe_streams_check(eng, plain, reqs, p_results, results)
    return launches, routing


def phase_ssm_profile(torch, cfg, params):
    import numpy as np
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, max_len=SSM_SYNC["max_len"], device="cuda")
    rng = np.random.default_rng(SSM_SYNC["seed"] + 1)
    prompt = rng.integers(0, cfg.vocab_size, (1, SSM_SYNC["max_len"])
                          ).astype(np.int32)
    profile(torch, f"{cfg.name} sync prefill ({SSM_SYNC['max_len']} rows)",
            lambda: eng.prefill(prompt)[0].argmax(-1).cpu(),
            parts={"mamba2_ssd": SSD_KERNELS})
    logits, cache = eng.prefill(prompt[:, :1024])
    tok = logits.argmax(-1)[:, None]
    profile(torch, f"{cfg.name} sync decode step (B=1, position 1024)",
            lambda: eng.decode(cache, tok, 1024).argmax(-1).cpu())


# -- phase 15: the MFMA contract ----------------------------------------------

def gemm_operands(torch, g, M: int, K: int, N: int, ab, c_dt):
    """a (M, K) and b (K, N) in ``ab``, b scaled by 1/sqrt(K) so that
    outputs stay near unit size, and c (M, N) in ``c_dt``."""
    a = torch.randn((M, K), generator=g, device="cuda").to(ab)
    b = (torch.randn((K, N), generator=g, device="cuda")
         / math.sqrt(K)).to(ab)
    c = torch.randn((M, N), generator=g, device="cuda").to(c_dt)
    return a, b, c


def gemm_records(torch):
    """``mfma_gemm`` held to its plain version at the shapes of
    ``GEMM_CASES``, the bf16 ones with f32 C timed beside the library
    call and their bound; returns the record of the prefill gate/up
    projection and every timed shape's numbers."""
    from repro_torch.kernels import mfma_gemm, mfma_gemm_plain
    g = torch.Generator(device="cuda").manual_seed(8)
    flush = l2_flush(torch)
    library_name = None
    record, timed_rows, max_abs_err = None, [], 0.0
    for label, (M, K, N, ab, c_dt, timed) in GEMM_CASES.items():
        ab, c_dt = getattr(torch, ab), getattr(torch, c_dt)
        a, b, c = gemm_operands(torch, g, M, K, N, ab, c_dt)
        got = mfma_gemm(a, b, c)
        torch.cuda.synchronize()
        want = mfma_gemm_plain(a, b, c)
        check(got.dtype == c_dt and tuple(got.shape) == (M, N),
              f"mfma_gemm ({label}): got {got.dtype} {tuple(got.shape)}")
        err = held_to_plain(torch, f"mfma_gemm ({label})", got, want)
        max_abs_err = max(max_abs_err, err)
        msg = (f"mfma_gemm {label}: M={M} K={K} N={N} a/b {ab} c {c_dt}: "
               f"max abs err {err:.3g}")
        if timed:
            if library_name is None:
                try:
                    torch.addmm(c, a, b, out_dtype=torch.float32)
                    library_name = "torch.addmm(c, a, b, out_dtype=float32)"
                except (RuntimeError, TypeError, NotImplementedError):
                    library_name = ("c + torch.mm(a, b).float() (the product"
                                    " rounded to bf16 before the sum)")
            if library_name.startswith("torch.addmm"):
                def library():
                    return torch.addmm(c, a, b, out_dtype=torch.float32)
            else:
                def library():
                    return c + torch.mm(a, b).float()
            big = M * N * K > 1 << 30
            ms = time_ms(torch, lambda: mfma_gemm(a, b, c),
                         20 if big else 100, flush)
            plain_ms = time_ms(torch, lambda: mfma_gemm_plain(a, b, c),
                               5 if big else 20, flush)
            library_ms = time_ms(torch, library, 20 if big else 100, flush)
            lib_err = float((library().float() - want.float()).abs().max())
            nbytes = (a.numel() + b.numel()) * a.element_size() \
                + 2 * c.numel() * c.element_size()
            flops = 2 * M * N * K
            bound_ms, bound_by = bound(nbytes, flops)
            n_dev = 10 if big else 50
            rec = {"device_ms": device_ms(torch, lambda: mfma_gemm(a, b, c),
                                          n_dev, flush),
                   "library_device_ms": device_ms(torch, library, n_dev,
                                                  flush),
                   "host_us": host_us(torch, lambda: mfma_gemm(a, b, c),
                                      20 if big else 100)}
            msg += (f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                    f"{nbytes / ms / 1e9:.3f} TB/s), plain {plain_ms:.4f} ms, "
                    f"{library_name} {library_ms:.4f} ms (max abs err vs "
                    f"plain {lib_err:.3g}), bound {bound_ms:.5f} ms "
                    f"({bound_by}: {nbytes} bytes, {flops} flops); "
                    + readings(rec, library="torch.addmm"))
            timed_rows.append({"shape": label, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": library_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               **rec})
            if label == GEMM_RECORD:
                record = {"name": "mfma_gemm", "route": "cuda",
                          "source": "src/repro_torch/csrc/mfma_gemm.cu",
                          "replaces": "src/repro/kernels/mfma_gemm.py:47",
                          "launches": None, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms}
        print(msg)
        del a, b, c, got, want
    torch.cuda.empty_cache()
    record["max_abs_err"] = max_abs_err
    print(f"mfma_gemm library call: {library_name}")
    return record, timed_rows


def compose_microops(torch, instr: str, a, b, c):
    """D of a GEMM accumulated over its (M/16 x N/16 x K/k) tiles, one
    ``core.functional.mfma_apply`` of ``instr`` each, on a and b's
    device."""
    from repro_torch.core import isa
    from repro_torch.core.functional import mfma_apply
    k = isa.lookup(instr).k
    d = c.clone()
    for i in range(0, a.shape[0], 16):
        for j in range(0, b.shape[1], 16):
            for kk in range(0, a.shape[1], k):
                blk = mfma_apply(instr, a[None, i:i + 16, kk:kk + k],
                                 b[None, kk:kk + k, j:j + 16],
                                 d[None, i:i + 16, j:j + 16])
                d[i:i + 16, j:j + 16] = blk[0]
    return d


def phase_mfma_contract(torch):
    """The MFMA contract layer through its entry points, counted: the
    accumulate contract at qwen2-7b's decode and prefill projection
    shapes, the GEMM against micro-op compositions of the functional
    oracle, and the oracle on the card against the CPU for every
    instruction.  Returns the launches of ``mfma_gemm``."""
    from repro_torch.core import isa
    from repro_torch.core.functional import mfma_apply, random_operands
    from repro_torch.kernels import (launch_counts, mfma_gemm,
                                     mfma_gemm_plain, reset_launch_counts)
    g = torch.Generator(device="cuda").manual_seed(9)
    reset_launch_counts()
    calls = 0
    # (b) integer-valued operands make every sum exact in f32 (|sums| <=
    # K x 16 < 2**24), so C = 3 and C = 0 must give outputs exactly 3
    # apart, and each must equal the plain version exactly
    for label in ("decode gate/up", "prefill gate/up"):
        M, K, N = GEMM_CASES[label][:3]
        a = torch.randint(-4, 5, (M, K), generator=g, device="cuda").to(
            torch.bfloat16)
        b = torch.randint(-4, 5, (K, N), generator=g, device="cuda").to(
            torch.bfloat16)
        c0 = torch.zeros((M, N), device="cuda")
        d0 = mfma_gemm(a, b, c0)
        d3 = mfma_gemm(a, b, c0 + 3.0)
        calls += 2
        check(bool(((d3 - d0) == 3.0).all()),
              f"mfma_gemm ({label}): C = 3 and C = 0 differ by "
              f"{float((d3 - d0).min())}..{float((d3 - d0).max())}, not 3")
        check(torch.equal(d0, mfma_gemm_plain(a, b, c0)),
              f"mfma_gemm ({label}): integer-valued sums are not exact")
        print(f"mfma_gemm accumulate ({label}, M={M} K={K} N={N}, integer-"
              "valued bf16): C = 3 minus C = 0 is exactly 3, sums exact")
        del a, b, c0, d0, d3
    # (c) the GEMM against micro-op compositions on the card
    for instr, (M, K, N), dt in (("fp32_16x16x4fp32", (128, 8, 128),
                                  torch.float32),
                                 ("fp32_16x16x16bf16", (128, 32, 128),
                                  torch.bfloat16)):
        a, b, c = gemm_operands(torch, g, M, K, N, dt, torch.float32)
        got = mfma_gemm(a, b, c)
        calls += 1
        want = compose_microops(torch, instr, a, b, c)
        err = float((got - want).abs().max())
        check(err <= 1e-4 + 1e-4 * float(want.abs().max()),
              f"mfma_gemm vs {instr} micro-ops: max abs err {err}")
        n_ops = (M // 16) * (N // 16) * (K // isa.lookup(instr).k)
        print(f"mfma_gemm {M}x{K}x{N} {dt} vs {n_ops} {instr} micro-ops on "
              f"the card: max abs err {err:.3g}")
    counts = launch_counts()
    # (d) the functional oracle on the card against the CPU: i8 exactly,
    # the rest to 1e-6 relative
    for name, instr in isa.MFMA_REGISTRY.items():
        a, b, c = random_operands(name, seed=1, device="cuda")
        got = mfma_apply(name, a, b, c)
        want = mfma_apply(name, a.cpu(), b.cpu(), c.cpu())
        check(got.device.type == "cuda" and got.dtype == want.dtype,
              f"mfma_apply({name}) on the card: {got.device} {got.dtype}")
        if instr.out_dtype == "i32":
            check(torch.equal(got.cpu(), want),
                  f"mfma_apply({name}) on the card is not exact")
        else:
            err = float((got.cpu() - want).abs().max() / want.abs().max())
            check(err <= 1e-6, f"mfma_apply({name}) on the card: max abs "
                  f"error {err} of the largest output > 1e-6")
    print(f"mfma_apply: all {len(isa.MFMA_REGISTRY)} instructions on the "
          "card equal the CPU (i8 exactly, the rest within 1e-6)")
    check(counts["mfma_gemm"] == calls,
          f"mfma_gemm launched {counts['mfma_gemm']} times for {calls} calls")
    check(all(v == 0 for k, v in counts.items() if k != "mfma_gemm"),
          f"the contract path launched other kernels: {counts}")
    print(f"MFMA contract launches: {counts}")
    return counts["mfma_gemm"]


# -- phases 16-19: the rest of the catalog --------------------------------------

ROW_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")


def shape_row(rec, shape: str):
    """One timed shape of a kernel, for its ``shapes`` in the record."""
    return dict({k: rec[k] for k in ROW_KEYS}, shape=shape)


def phase_dense_kernels(torch, cfg, params, records):
    """Phase 2's kernel checks and timings at ``cfg``'s grouping: the
    paged decode tick, flash over a 2048-row causal prefill and decode
    over mixed lengths, each added to its kernel's ``shapes``."""
    G = cfg.n_heads // cfg.n_kv_heads
    tag = f"{cfg.name} (H={cfg.n_heads} over KV={cfg.n_kv_heads}, G={G}, " \
          f"hd={cfg.hd})"
    probe = new_engine(cfg, params)
    rec = phase_kernels(torch, cfg, probe.page, probe.nb_table)
    records["paged"]["shapes"].append(shape_row(
        rec, f"{tag}: B=8 ragged lengths, page {probe.page}"))
    del probe
    rec = flash_records(torch, cfg, moe_grouping=False)
    records["flash"]["shapes"].append(shape_row(
        rec, f"{tag}: causal S=T=2048"))
    rec = decode_record(torch, cfg)
    records["decode"]["shapes"].append(shape_row(
        rec, f"{tag}: B=8, T=2048, mixed lengths"))
    torch.cuda.empty_cache()


def phase_dense_sync(torch, cfg, params):
    """The sync engine serves prompts of 2000 and 517 tokens one at a
    time; launch counts, a decode step's logits against the plain path
    (with the float32 yardstick) and the streams."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, max_len=DENSE_SYNC["max_len"],
                      device="cuda")
    eng.generate(np.arange(16, dtype=np.int32)[None], n_steps=2)   # warm-up
    rng = np.random.default_rng(DENSE_SYNC["seed"])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, s)
                    .astype(np.int32), n_steps=DENSE_SYNC["n_steps"])
            for s in DENSE_SYNC["prompts"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts())
    check_sync_launches(cfg, launches, len(reqs), stats.decode_steps)
    for r in results:
        check(len(r.tokens) == DENSE_SYNC["n_steps"], f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    n_run = sum(len(r.tokens) for r in results)
    print(f"ServeEngine {cfg.name} ({cfg.n_layers} layers) bf16, max_len "
          f"{DENSE_SYNC['max_len']}: run(batch=1) of prompts "
          f"{list(DENSE_SYNC['prompts'])} x {DENSE_SYNC['n_steps']} greedy "
          f"tokens in {wall:.3f} s ({n_run / wall:.1f} tok/s); {len(reqs)} "
          f"prefills, {stats.decode_steps} decode steps, launches {launches}")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    prompt = reqs[0].prompt[None]
    logits, cache = eng.prefill(prompt)
    tok = logits.argmax(-1)[:, None]
    logit_check(torch, f"{cfg.name} sync decode step at position "
                       f"{prompt.shape[1]}", cfg, plain_cfg, params, cache,
                lambda c, p, cc: decode_step(c, p, cc, tok,
                                             prompt.shape[1])[0])
    del cache
    streams_check(torch, eng, ServeEngine(
        plain_cfg, params, max_len=DENSE_SYNC["max_len"], device="cuda"),
        reqs, results)
    return launches


def phase_dense_catalog(torch, records):
    """internlm2-20b, mistral-nemo-12b and yi-34b at full width, each cut
    to DENSE["n_layers"] layers: phase 2's kernels at its grouping, the
    paged engine on phase 3's trace, the sync engine on two prompts."""
    from repro_torch.configs import get_config
    for i, arch in enumerate(DENSE["archs"]):
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=DENSE["n_layers"])
        torch.cuda.reset_peak_memory_stats()
        params = draw_params(
            torch, cfg, DENSE["seed"] + i,
            f"{cfg.name} full width (d_model {cfg.d_model}, {cfg.n_heads} "
            f"query heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}) cut in depth from "
            f"{full.n_layers} to {cfg.n_layers} layers "
            f"(dataclasses.replace(cfg, n_layers={DENSE['n_layers']}))")
        phase_dense_kernels(torch, cfg, params, records)
        launches, _, _ = phase_serve(torch, cfg, params)
        records["paged"]["launches_by_phase"][f"16 {arch}"] = \
            launches["paged_decode_attention"]
        launches = phase_dense_sync(torch, cfg, params)
        for key, name in (("flash", "flash_attention"),
                          ("decode", "decode_attention")):
            records[key]["launches_by_phase"][f"16 {arch}"] = launches[name]
        print(f"phase 16 {arch}: {time.perf_counter() - t0:.1f} s, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              " GiB")
        del params
        torch.cuda.empty_cache()


def phase_mla(torch, records):
    """deepseek-v2-lite-16b at full width and depth through the sync
    engine: ``moe_gmm`` at its expert shapes, the run with its launch
    counts (no attention kernel: MLA), a decode step's logits and routing
    and the streams by the MoE rules of 9."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config(MLA["arch"])
    m, e = cfg.mla, cfg.moe
    D, F = cfg.d_model, e.d_ff_expert
    # capacities: a B = 1 decode step (4), the B = 8 check step's 8 groups
    # folded into each expert's rows (32), a 2000-token prefill (236)
    rec = moe_gmm_record(torch, cfg, cases={
        "decode gate/up (B = 1)": (4, D, F, True),
        "decode down (B = 1)": (4, F, D, True),
        "decode gate/up (B = 8)": (32, D, F, True),
        "prefill gate/up (S = 2000)": (236, D, F, True),
        "prefill down (S = 2000)": (236, F, D, True)}, seed=14)
    records["moe"]["shapes"] += rec["shapes"]
    records["moe"]["max_abs_err"] = max(records["moe"]["max_abs_err"],
                                        rec["max_abs_err"])
    torch.cuda.reset_peak_memory_stats()
    params = draw_params(
        torch, cfg, MLA["seed"],
        f"{cfg.name} full width and depth ({cfg.n_layers} layers: MLA with "
        f"{cfg.n_heads} heads, latent {m.kv_lora_rank}, query/key heads "
        f"{m.qk_nope_dim} + {m.qk_rope_dim}, value heads {m.v_head_dim}; "
        f"{cfg.first_k_dense} dense FFN layer of {cfg.d_ff}, then "
        f"{cfg.n_layers - cfg.first_k_dense} MoE layers of {e.n_experts} "
        f"experts top-{e.top_k} of width {F} and {e.n_shared} shared of "
        f"{e.d_ff_shared} together; d_model {D}, vocab {cfg.vocab_size})")
    eng = ServeEngine(cfg, params, max_len=MLA_SYNC["max_len"], device="cuda")
    eng.generate(np.arange(16, dtype=np.int32)[None], n_steps=2)   # warm-up
    rng = np.random.default_rng(MLA_SYNC["seed"])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, s)
                    .astype(np.int32), n_steps=MLA_SYNC["n_steps"])
            for s in MLA_SYNC["prompts"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts())
    check_sync_launches(cfg, launches, len(reqs), stats.decode_steps)
    for r in results:
        check(len(r.tokens) == MLA_SYNC["n_steps"], f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    n_run = sum(len(r.tokens) for r in results)
    print(f"ServeEngine {cfg.name} bf16, max_len {MLA_SYNC['max_len']}: "
          f"run(batch=1) of prompts {list(MLA_SYNC['prompts'])} x "
          f"{MLA_SYNC['n_steps']} greedy tokens in {wall:.3f} s "
          f"({n_run / wall:.1f} tok/s); {len(reqs)} prefills, "
          f"{stats.decode_steps} decode steps, launches {launches}")
    records["moe"]["launches_by_phase"]["17 " + cfg.name] = launches["moe_gmm"]
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    plain = ServeEngine(plain_cfg, params, max_len=MLA_SYNC["max_len"],
                        device="cuda")
    p_results, _ = plain.run(reqs)
    moe_streams_check(eng, plain, reqs, p_results, results, later=True)
    del plain
    batch = rng.integers(0, cfg.vocab_size, MLA_SYNC["check_batch"]
                         ).astype(np.int32)
    logits, cache = eng.prefill(batch)
    del eng
    tok = logits.argmax(-1)[:, None]
    pos = batch.shape[1]
    f32_routing_check(
        torch, f"{cfg.name} sync decode step (B={batch.shape[0]}, position "
               f"{pos})", cfg, params, cache, tok,
        lambda c, p, cc, t: decode_step(c, p, cc, t, pos)[0])
    print(f"phase 17: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, cache
    torch.cuda.empty_cache()


def f32_routing_readings(torch, label, cfg, params, state, tok, step):
    """One MoE decode step run five ways on identical state, with routing
    logged: the kernel path, the plain path, and the plain path token by
    token (cuBLAS's M = 1 kernels: the same function, rounded otherwise)
    in bf16, then the plain path in float32 with the weights converted
    in place (``params`` is float32 after: a float32 copy beside the
    bf16 one does not fit the card).  Prints and returns, for each pair,
    the (token, layer) pairs whose top-k sets differ and each token's
    first such layer with the second run's top-k/top-(k+1) margin
    there, and each bf16 run's logits' relative distance from float32's.
    ``step(cfg, params, state, tokens)`` returns the logits; ``state``'s
    leading axis and ``tok``'s rows are the step's tokens."""
    from repro_torch.serve.parity import routing_differences, routing_log
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    B = tok.shape[0]
    out, logs = {}, {}

    def run(c, st, t):
        with routing_log() as log:
            y = step(c, params, st, t).float()
        return y, log

    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        out[name], logs[name] = run(c, _map(lambda t: t.clone(), state), tok)
    rows, per_row = [], []
    for b in range(B):
        y, log = run(plain_cfg, _map(lambda t: t[b:b + 1].clone(), state),
                     tok[b:b + 1])
        rows.append(y)
        per_row.append(log)
    out["plain B=1"] = torch.cat(rows)
    logs["plain B=1"] = [torch.cat([t[i] for t in per_row])
                         for i in range(len(per_row[0]))]
    check(bool(torch.isfinite(out["kernel"]).all()), "non-finite logits")

    def upcast(tree):
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if isinstance(v, (dict, list)):
                upcast(v)
            else:
                tree[k] = v.float()

    upcast(params)                      # in place: leaf by leaf
    torch.cuda.empty_cache()
    out["f32"], logs["f32"] = run(
        dataclasses.replace(plain_cfg, dtype="float32"),
        _map(lambda t: t.float(), state), tok)
    top_k, n_calls = cfg.moe.top_k, len(logs["f32"])
    pairs = {}
    for a, ref in (("kernel", "plain"), ("plain B=1", "plain"),
                   ("kernel", "f32"), ("plain", "f32"),
                   ("plain B=1", "f32")):
        first, n = {}, 0
        for call, diff in routing_differences(top_k, logs[a], logs[ref]):
            n += len(diff)
            for r, m in diff:
                first.setdefault(r, (call, m))
        pairs[f"{a} vs {ref}"] = {"differing": n, "first": {
            r: {"layer": l, "margin": m} for r, (l, m) in sorted(first.items())}}
        margins = [m for _, m in first.values()]
        print(f"{label}: {a} vs {ref}: {n} of {B * n_calls} (token, layer) "
              f"pairs route to different top-{top_k} sets; {len(first)} of "
              f"{B} tokens flip, {sum(m >= ROUTING_MARGIN for m in margins)} "
              f"first at a {ref} top-{top_k}/top-{top_k + 1} margin >= "
              f"{ROUTING_MARGIN} (largest first margin "
              f"{max(margins, default=0.0):.6f})")
    rel = {name: float((out[name] - out["f32"]).norm() / out["f32"].norm())
           for name in ("kernel", "plain", "plain B=1")}
    print(f"{label} logits against float32: kernel path {rel['kernel']:.5f}, "
          f"plain path {rel['plain']:.5f}, plain path token by token "
          f"{rel['plain B=1']:.5f}")
    return {"pairs": pairs, "logits_rel_to_f32": rel}


def f32_routing_check(torch, label, cfg, params, state, tok, step):
    """deepseek's decode step held to float32.  Phase 9's routing rule
    (a token may route differently from the plain path only first where
    the plain top-k/top-(k+1) margin is below ``ROUTING_MARGIN``) lies
    below the plain path's own rounding noise at this depth and router:
    run token by token, the plain path flips routing against itself at
    every token, some first at margins above the limit.  So the step is
    held to float32 (``f32_routing_readings``), as the other phases are:
    the kernel path's logits no further from float32 than 1.5x the plain
    path's, and its routing differing from float32's at no more (token,
    layer) pairs than 1.5x the plain path's.  ``params`` is float32
    after."""
    r = f32_routing_readings(torch, label, cfg, params, state, tok, step)
    rel, pairs = r["logits_rel_to_f32"], r["pairs"]
    k32, p32 = pairs["kernel vs f32"]["differing"], \
        pairs["plain vs f32"]["differing"]
    check(rel["kernel"] <= 1.5 * rel["plain"], f"{label}: the kernel path is "
          f"further from float32 ({rel['kernel']:.4g}) than 1.5x the plain "
          f"path ({rel['plain']:.4g})")
    check(k32 <= 1.5 * p32, f"{label}: the kernel path routes unlike float32 "
          f"at {k32} (token, layer) pairs, more than 1.5x the plain path's "
          f"{p32}")


class ModelLoop:
    """The model-level greedy loop, ``prefill`` then ``decode_step`` fed
    its own argmax, with the model's media or frames (``extras``): how
    the models whose engines take no media are driven (as the
    reference's ``tests/test_arch_smoke.py`` drives them).  ``run`` and
    ``teacher_forced_logits`` speak the engines' protocol, so the
    near-tie rule of ``repro_torch.serve.parity`` applies."""

    def __init__(self, cfg, params, extras, max_len: int):
        self.cfg, self.params = cfg, params
        self.extras, self.max_len = extras, max_len

    def prefill(self, prompt):
        """(V,) logits of the prompt's last token, and the cache."""
        import torch
        from repro_torch.models import prefill
        toks = torch.tensor(prompt[None], dtype=torch.int32, device="cuda")
        logits, cache = prefill(self.cfg, self.params,
                                dict(self.extras, tokens=toks), self.max_len)
        return logits[0, -1], cache

    def decode(self, cache, tok, pos: int):
        from repro_torch.models import decode_step
        return decode_step(self.cfg, self.params, cache, tok.view(1, 1),
                           pos)[0][0, -1]

    def run(self, reqs):
        """Each request alone, greedy: (results, stats) as the engines'
        ``run(batch=1)`` returns them."""
        import numpy as np
        import torch
        from repro_torch.serve import RequestResult, RunStats
        out = []
        for r in reqs:
            logits, cache = self.prefill(r.prompt)
            S, toks = r.prompt.shape[0], []
            for i in range(r.n_steps):
                tok = logits.argmax()
                toks.append(tok)
                logits = self.decode(cache, tok, S + i)
            out.append(RequestResult(
                tokens=torch.stack(toks).cpu().numpy().astype(np.int32),
                prompt_len=S, arrival=0, admitted=len(out),
                finished=len(out), emit_times=[]))
            del cache
        steps = sum(r.n_steps for r in reqs)
        return out, RunStats(requests=len(reqs), tokens=steps,
                             decode_steps=steps, batches=len(reqs))

    def teacher_forced_logits(self, prompt, tokens):
        import torch
        logits, cache = self.prefill(prompt)
        out, S = [logits], prompt.shape[0]
        for t, tok in enumerate(list(tokens)[:-1]):
            out.append(self.decode(cache, torch.tensor(
                [[tok]], dtype=torch.int32, device="cuda"), S + t))
        return out


def loop_phase(torch, label, cfg, params, extras, run):
    """Greedy loops of ``run``'s prompts through ``ModelLoop``: launch
    counts, a decode step's and a prefill's logits against the plain path
    (with the float32 yardstick) and the streams against the plain
    path's."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import Request
    loop = ModelLoop(cfg, params, extras, run["max_len"])
    loop.run([Request(prompt=np.arange(16, dtype=np.int32), n_steps=2)])
    rng = np.random.default_rng(run["seed"])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, s)
                    .astype(np.int32), n_steps=run["n_steps"])
            for s in run["prompts"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, stats = loop.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts())
    steps = stats.decode_steps
    check_sync_launches(cfg, launches, len(reqs), steps)
    for r in results:
        check(len(r.tokens) == run["n_steps"], f"{len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "token out of vocabulary range")
    print(f"{label}: prefill + decode_step greedy loops of prompts "
          f"{list(run['prompts'])} x {run['n_steps']} tokens in {wall:.3f} s "
          f"({len(reqs) * run['n_steps'] / wall:.1f} tok/s); {len(reqs)} "
          f"prefills, {steps} decode steps, launches {launches}")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    prompt = reqs[1].prompt
    toks = torch.tensor(prompt[None], dtype=torch.int32, device="cuda")
    logit_check(torch, f"{label} prefill of {prompt.shape[0]} tokens", cfg,
                plain_cfg, params, extras,
                lambda c, p, ex: prefill(c, p, dict(ex, tokens=toks),
                                         run["max_len"])[0])
    logits, cache = loop.prefill(prompt)
    tok = logits.argmax().view(1, 1)
    logit_check(torch, f"{label} decode step at position {prompt.shape[0]}",
                cfg, plain_cfg, params, cache,
                lambda c, p, cc: decode_step(c, p, cc, tok,
                                             prompt.shape[0])[0])
    del cache
    plain = ModelLoop(plain_cfg, params, extras, run["max_len"])
    streams_check(torch, loop, plain, reqs, results)
    return launches


def phase_vlm(torch, records):
    """llama-3.2-vision-90b at full width cut to two periods: media from
    the seed, cross gates from the seed, non-causal flash over the media
    and decode over every media row checked and timed, then the greedy
    loops."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import layer_sigs
    full = get_config(VLM["arch"])
    cfg = dataclasses.replace(full, n_layers=VLM["n_layers"])
    M = cfg.cross_attn.n_media_tokens
    G = cfg.n_heads // cfg.n_kv_heads
    g = torch.Generator(device="cuda").manual_seed(VLM["seed"] + 100)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    S = VLM_RUN["prompts"][0]
    q, k, v = (randn(1, S, cfg.n_heads, cfg.hd), randn(1, M, cfg.n_kv_heads,
                                                       cfg.hd),
               randn(1, M, cfg.n_kv_heads, cfg.hd))
    rec = flash_timing(torch, q, k, v, causal=False)
    print(f"flash_attention non-causal S={S} T={M} (the cross layers' "
          f"prefill) H={cfg.n_heads} KV={cfg.n_kv_heads} hd={cfg.hd} bf16: "
          f"max abs err {rec['max_abs_err']:.3g}; kernel {rec['ms']:.4f} ms "
          f"({rec['flops'] / rec['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms (max abs "
          f"err vs plain {rec['lib_err']:.3g}), bound {rec['bound_ms']:.5f} ms "
          f"({rec['bound_by']}: {rec['nbytes']} bytes, {rec['flops']} flops); "
          + readings(rec))
    records["flash"]["shapes"].append(shape_row(
        rec, f"{cfg.name} cross prefill: non-causal S={S}, T={M}, G={G}, "
             f"hd={cfg.hd}"))
    for B in (1, 8):
        qd = randn(B, cfg.n_heads, cfg.hd)
        kd, vd = (randn(B, M, cfg.n_kv_heads, cfg.hd) for _ in range(2))
        lens = torch.full((B,), M, dtype=torch.int32, device="cuda")
        rec = decode_timing(torch, qd, kd, vd, lens)
        print(f"decode_attention B={B} over {M} media rows (the cross "
              f"layers' decode step) G={G} hd={cfg.hd} bf16: max abs err "
              f"{rec['max_abs_err']:.3g}; kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms (max "
              f"abs err vs plain {rec['lib_err']:.3g}), bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: {rec['nbytes']} "
              "bytes); " + readings(rec))
        records["decode"]["shapes"].append(shape_row(
            rec, f"{cfg.name} cross decode: B={B} over T={M} media rows, "
                 f"G={G}, hd={cfg.hd}"))
        del qd, kd, vd
    del q, k, v
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    params = draw_params(
        torch, cfg, VLM["seed"],
        f"{cfg.name} full width (d_model {cfg.d_model}, {cfg.n_heads} query "
        f"heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, a cross layer every "
        f"{cfg.cross_attn.period} over {M} media rows) cut in depth from "
        f"{full.n_layers} to {cfg.n_layers} layers "
        f"(dataclasses.replace(cfg, n_layers={VLM['n_layers']}))")
    # the reference starts every gate at zero, where no cross-attention
    # reaches the residual; draw them from the seed
    cross = [i for i, s in enumerate(layer_sigs(cfg)) if s[0] == "cross"]
    for i in cross:
        params["layers"][i]["gate"] = torch.rand(
            (), generator=g, device="cuda") * 0.5 + 0.25
    print(f"cross layers {cross}, gates "
          f"{[round(float(params['layers'][i]['gate']), 4) for i in cross]}"
          " (uniform in [0.25, 0.75] from the seed)")
    media = randn(1, M, cfg.d_model) * 1.0
    launches = loop_phase(torch, cfg.name, cfg, params, {"media": media},
                          VLM_RUN)
    for key, name in (("flash", "flash_attention"),
                      ("decode", "decode_attention")):
        records[key]["launches_by_phase"]["18 " + cfg.name] = launches[name]
    print(f"phase 18: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, media
    torch.cuda.empty_cache()


def phase_encoder(torch, records):
    """whisper-base at full width and depth: non-causal flash over the
    frames checked and timed, ``_encode`` against the plain path's, then
    the greedy loops."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import _encode
    cfg = get_config(ENC["arch"])
    F = cfg.encoder.n_frames
    g = torch.Generator(device="cuda").manual_seed(ENC["seed"] + 100)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = (randn(1, F, cfg.n_heads, cfg.hd) for _ in range(3))
    rec = flash_timing(torch, q, k, v, causal=False)
    print(f"flash_attention non-causal S=T={F} (the encoder) H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} hd={cfg.hd} bf16: max abs err "
          f"{rec['max_abs_err']:.3g}; kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms (max abs "
          f"err vs plain {rec['lib_err']:.3g}), bound {rec['bound_ms']:.5f} ms "
          f"({rec['bound_by']}: {rec['nbytes']} bytes, {rec['flops']} flops); "
          + readings(rec))
    records["flash"]["shapes"].append(shape_row(
        rec, f"{cfg.name} encoder: non-causal S=T={F}, G=1, hd={cfg.hd}"))
    del q, k, v
    params = draw_params(
        torch, cfg, ENC["seed"],
        f"{cfg.name} full width and depth ({cfg.encoder.n_layers} encoder "
        f"layers over {F} frames, {cfg.n_layers} decoder layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, vocab "
        f"{cfg.vocab_size}, learned positions, tied embeddings)")
    frames = randn(1, F, cfg.d_model)
    enc = {}
    for name, c in (("kernel", cfg),
                    ("plain", dataclasses.replace(cfg, use_kernels=False))):
        enc[name] = _encode(c, params, frames).float()
    r = float((enc["kernel"] - enc["plain"]).norm() / enc["plain"].norm())
    print(f"_encode of {F} frames: kernel vs plain path relative error "
          f"{r:.3g} (limit {LOGIT_REL_TOL})")
    check(bool(torch.isfinite(enc["kernel"]).all()), "_encode: non-finite")
    check(r < LOGIT_REL_TOL, f"_encode: kernel vs plain path relative error "
          f"{r:.3g} >= {LOGIT_REL_TOL}")
    launches = loop_phase(torch, cfg.name, cfg, params, {"frames": frames},
                          ENC_RUN)
    for key, name in (("flash", "flash_attention"),
                      ("decode", "decode_attention")):
        records[key]["launches_by_phase"]["19 " + cfg.name] = launches[name]
    del params, frames
    torch.cuda.empty_cache()


# -- phase 20: training -------------------------------------------------------

def grad_agreement(g16, g32):
    """(relative norm error, cosine, worst leaf, its relative error) of
    the bf16 gradient tree against the float32 one, in f64 sums."""
    from repro_torch.tree import flatten_with_path
    num = den = dot = n16 = 0.0
    worst = ("", 0.0)
    for (path, a), b in zip(flatten_with_path(g16), _leaves(g32)):
        a, b = a.float(), b.float()
        d2 = float((a - b).double().square().sum())
        b2 = float(b.double().square().sum())
        num, den = num + d2, den + b2
        dot += float((a.double() * b.double()).sum())
        n16 += float(a.double().square().sum())
        rel = math.sqrt(d2 / b2) if b2 > 0 else math.inf
        if rel > worst[1]:
            worst = ("/".join(map(str, path)), rel)
    return math.sqrt(num / den), dot / math.sqrt(n16 * den), worst


def train_flops(cfg, n_matmul_params: int, tokens: int, seq: int) -> float:
    """Model FLOP of one step: 6 x the parameters that multiply x tokens
    (forward and backward), plus the attention score and value products,
    12 x layers x H x hd x S per token (causal masking not subtracted;
    remat's recompute not counted)."""
    return (6.0 * n_matmul_params * tokens
            + 12.0 * cfg.n_layers * cfg.n_heads * cfg.hd * seq * tokens)


def phase_train(torch):
    """Phase 20 (see the module docstring)."""
    from repro_torch.arch import get_device
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, prefetch_to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import (OptConfig, adamw_update, init_opt_state,
                                   make_train_step)
    from repro_torch.train.step import loss_and_grads
    full = get_config(TRAIN["arch"])
    cfg = dataclasses.replace(full, n_layers=TRAIN["n_layers"],
                              use_kernels=False, remat="full",
                              microbatches=TRAIN["microbatches"])
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    params = draw_params(
        torch, cfg, TRAIN["seed"],
        f"{cfg.name} full width (d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads of "
        f"{cfg.hd}, vocab {cfg.vocab_size}) cut in depth from "
        f"{full.n_layers} to {cfg.n_layers} layers for training")
    n_params = sum(t.numel() for t in _leaves(params))
    n_matmul = n_params - params["embed"].numel()
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    data = SyntheticLM(cfg.vocab_size, batch=B, seq_len=S, seed=0,
                       correlation=0.9)
    batches = prefetch_to_device((data(i) for i in range(TRAIN["steps"])),
                                 size=2, device="cuda")
    batch0 = next(batches)

    # (a) the bf16 gradient against a float32 copy's, before the optimizer
    # state exists
    t0 = time.perf_counter()
    _, m16, g16 = loss_and_grads(cfg, params, batch0)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _map(lambda t: t.float(), params)
    _, m32, g32 = loss_and_grads(cfg32, p32, batch0)
    del p32
    rel, cos, (worst, worst_rel) = grad_agreement(g16, g32)
    ce16, ce32 = float(m16["ce"]), float(m32["ce"])
    del g16, g32
    torch.cuda.empty_cache()
    ce_rel = abs(ce16 - ce32) / abs(ce32)
    print(f"phase 20 (a): bf16 gradient vs float32: relative norm error "
          f"{rel:.5f} (limit {GRAD_REL_TOL}), cosine {cos:.6f} (at least "
          f"{GRAD_COS_MIN}), worst leaf {worst} at {worst_rel:.5f}; CE "
          f"bf16 {ce16:.6f}, float32 {ce32:.6f}, relative {ce_rel:.2e} "
          f"(limit {CE_REL_TOL}); {time.perf_counter() - t0:.1f} s")
    check(rel < GRAD_REL_TOL, f"phase 20: the bf16 gradient lies {rel:.5f} "
          f"from float32's (relative norm), over {GRAD_REL_TOL}")
    check(cos >= GRAD_COS_MIN, f"phase 20: the bf16 and float32 gradients' "
          f"cosine {cos:.6f} is under {GRAD_COS_MIN}")
    check(ce_rel < CE_REL_TOL, f"phase 20: bf16 CE {ce16} lies {ce_rel:.2e} "
          f"from float32's {ce32}, over {CE_REL_TOL}")

    # (b) the loss falls over 8 steps; (c) their times
    opt = OptConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup_steps"],
                    total_steps=TRAIN["steps"])
    step = make_train_step(cfg, opt)
    state = (params, init_opt_state(params))
    del params
    losses, walls = [], []
    batch = batch0
    for i in range(TRAIN["steps"]):
        if i:
            batch = next(batches)
        t0 = time.perf_counter()
        p, o, m = step(*state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        state = (p, o)
        losses.append(float(m["loss"]))
        print(f"phase 20 (b) step {i}: loss {losses[-1]:.6f}, grad_norm "
              f"{float(m['grad_norm']):.6f}, lr {float(m['lr']):.3e}, "
              f"{walls[-1] * 1e3:.1f} ms")
    last3 = sum(losses[-3:]) / 3
    check(last3 < losses[0], f"phase 20: the loss did not fall: step 0 "
          f"{losses[0]}, mean of the last 3 {last3}")
    wall = sum(walls[2:]) / len(walls[2:])
    tokens = B * S
    flops = train_flops(cfg, n_matmul, tokens, S)
    peak = get_device("h100").peak_flops
    share = flops / wall / peak
    print(f"phase 20 (c): {n_params / 1e9:.3f} B params ({n_matmul / 1e9:.3f}"
          f" B that multiply); steps 2-{TRAIN['steps'] - 1} mean wall "
          f"{wall * 1e3:.1f} ms, {tokens / wall:.0f} tokens/s; {flops:.4e} "
          f"model FLOP a step, {flops / wall / 1e12:.1f} TFLOP/s, "
          f"{100 * share:.1f}% of the bf16 peak ({peak / 1e12:.0f} TFLOP/s)")
    profile(torch, f"train step (qwen2-7b, {cfg.n_layers} layers, {B} x {S} "
                   f"tokens, {cfg.microbatches} microbatches)",
            lambda: step(*state, batch)[2]["loss"].item(), n_wall=2,
            parts={"GEMMs (cuBLAS)": ("nvjet", "gemm", "cutlass", "xmma")})
    t_grads, t_opt = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        _, _, grads = loss_and_grads(cfg, state[0], batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw_update(opt, state[0], grads, state[1])
        torch.cuda.synchronize()
        t_grads.append(t1 - t0)
        t_opt.append(time.perf_counter() - t1)
        del grads
    print(f"phase 20 (c): of a step, forward and backward (2 microbatches) "
          f"{min(t_grads) * 1e3:.1f} ms, the AdamW update "
          f"{min(t_opt) * 1e3:.1f} ms (wall, the faster of 2 calls each)")
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"phase 20: the training path launched kernels "
          f"{launched}; it has no backward through them")
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 20: peak device memory {peak_mem:.2f} GiB; kernel "
          f"launches 0")
    del state, p, o, m, batch, batch0
    torch.cuda.empty_cache()

    # (d) the controller and checkpoints at the example's smoke preset
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    c = CONTROLLER
    with tempfile.TemporaryDirectory() as tmp:
        _, (pa, _), _, ctl_a, dt_a = example.train(
            c["preset"], steps=c["steps"], ckpt_dir=f"{tmp}/a",
            ckpt_every=c["ckpt_every"], device="cuda")
        _, (pb, _), log_b, ctl_b, dt_b = example.train(
            c["preset"], steps=c["steps"], ckpt_dir=f"{tmp}/b",
            ckpt_every=c["ckpt_every"], inject_failure=c["fail_at"],
            device="cuda")
    num = sum(float((a.float() - b.float()).double().square().sum())
              for a, b in zip(_leaves(pa), _leaves(pb)))
    den = sum(float(a.float().double().square().sum()) for a in _leaves(pa))
    drift = math.sqrt(num / den)
    restart = [e for e in log_b if e.get("event") == "restart"]
    print(f"phase 20 (d): smoke preset, {c['steps']} steps, checkpoints "
          f"every {c['ckpt_every']}: uninterrupted {dt_a:.2f} s, with a "
          f"failure at step {c['fail_at']} {dt_b:.2f} s, restarts "
          f"{ctl_b.restarts} ({restart}); final parameters "
          f"{drift:.3e} apart (relative norm, limit {c['rel_tol']})")
    check(ctl_a.restarts == 0 and ctl_b.restarts == 1,
          f"phase 20: restarts {ctl_a.restarts} and {ctl_b.restarts}, "
          f"expected 0 and 1")
    check(drift < c["rel_tol"], f"phase 20: the restarted run's parameters "
          f"lie {drift:.3e} from the uninterrupted run's, over "
          f"{c['rel_tol']}")


# -- phase 21: the paper's timing model and the Listing-1 probe ----------------

def phase_timing_model(torch):
    """(a) Tables II-VI from the port's timing model on the card's host;
    (b) every Listing-1 variant's stream on the card, counted, its D held
    to the plain version exactly; (c) T_total rising in N, Eq. 1 read
    through the port's ``eq1_latency``.  Returns the probe's record."""
    from repro_torch.core.machine import get_machine
    from repro_torch.core.microbench import latency_table
    from repro_torch.core.whatif import scale_table
    from repro_torch.kernels import launch_counts, reset_launch_counts
    # the module: the package re-exports its wrapper under its name
    probe = importlib.import_module("repro_torch.kernels.listing1")
    t0 = time.perf_counter()
    # (a)
    for gpu, expected in PAPER_EXPECTED.items():
        got = latency_table(get_machine(gpu))
        want = {name: {n: float(c) for n in (2, 3, 4, 5)}
                for name, c in expected.items()}
        check(got == want, f"phase 21: {gpu}'s Listing-1 table {got} is "
              f"not the paper's Expected column {want}")
    t6 = scale_table(get_machine("mi300"), scales=(1.0, 2.0))
    check(len(t6) == len(PAPER_EXPECTED["mi300"]) and all(
        v[2.0] == 2 * v[1.0] for v in t6.values()),
        f"phase 21: Table VI (mi300, --mfma-scale 2) does not double: {t6}")
    print(f"phase 21 (a): Tables II-V (mi200 {len(PAPER_EXPECTED['mi200'])}, "
          f"mi300 {len(PAPER_EXPECTED['mi300'])} instructions, N 2..5) equal "
          "the Expected column; Table VI doubles every mi300 latency")

    # (b) the main path: every variant at every N, counted
    ns, launches = LISTING1["ns"], LISTING1["launches"]
    reset_launch_counts()
    medians, spans = {}, {}
    for kind in probe.KINDS:
        medians[kind] = {}
        for n in ns:
            med, totals, ds, want = probe.stream_cycles(
                kind, n, launches=launches, seed=LISTING1["seed"] + n)
            bad = int((ds != want).flatten(1).any(1).sum())
            check(bad == 0, f"listing1 {kind} N={n}: D differs from the "
                  f"plain version in {bad} of {launches} launches")
            medians[kind][n] = med
            spans[(kind, n)] = (min(totals), max(totals))
    counts = dict(launch_counts())
    want_launches = len(probe.KINDS) * len(ns) * launches
    check(counts["listing1"] == want_launches, f"listing1 launched "
          f"{counts['listing1']} times for {want_launches} streams")
    check(all(v == 0 for k, v in counts.items() if k != "listing1"),
          f"the probe launched other kernels: {counts}")
    print(f"phase 21 (b): {want_launches} launches ({len(probe.KINDS)} "
          f"variants x N in {list(ns)} x {launches}); D equal to the plain "
          "version in every launch")

    # (c)
    cycles = {}
    for kind, med in medians.items():
        check(med[ns[0]] > 0 and all(med[a] < med[b] for a, b in
                                     zip(ns, ns[1:])),
              f"listing1 {kind}: T_total {med} is not positive and "
              "strictly increasing in N")
        eq1 = probe.eq1_cycles(med)
        issue = med[1] - med[0]
        eq1_issue = probe.eq1_cycles(med, t_inst=issue)
        slope = probe.least_squares_slope(med)
        vals = [eq1[n] for n in (2, 3, 4, 5)]
        spread = (max(vals) - min(vals)) / (sum(vals) / len(vals))
        cycles[kind] = {"ptx": probe.KINDS[kind].ptx, "t_total": med,
                        "overhead": med[0], "issue": issue, "eq1": eq1,
                        "eq1_t_inst_issue": eq1_issue, "slope": slope,
                        "spread": spread}
        print(f"listing1 {kind} ({probe.KINDS[kind].ptx}): median T_total "
              f"{med} cycles (min..max over {launches} launches: "
              f"{ {n: spans[(kind, n)] for n in ns} }); overhead (N = 0) "
              f"{med[0]}, one mma's issue (N = 1 less N = 0) {issue}; Eq. 1 "
              f"(t_memtime {med[0]}, t_inst 0) {eq1}, spread across N "
              f"{spread:.2%}; least-squares slope {slope:.3f} cycles/mma; "
              f"Eq. 1 with t_inst {issue}: {eq1_issue}")

    # the record: one variant timed beside its plain version, the library
    # call and the bound (a latency probe: the bound is nanoseconds)
    kind, n = LISTING1["record"]
    a, b, c = probe.operands(kind, seed=LISTING1["seed"])
    want = probe.listing1_plain(a, b, c, n)
    got, _ = probe.listing1(a, b, c, n)
    torch.cuda.synchronize()
    max_abs_err = float((got.double() - want.double()).abs().max())
    check(max_abs_err == 0.0, f"listing1 {kind} N={n}: max abs err "
          f"{max_abs_err} against the plain version")

    def nothing():
        return None
    ms = time_ms(torch, lambda: probe.listing1(a, b, c, n), 200, nothing)
    plain_ms = time_ms(torch, lambda: probe.listing1_plain(a, b, c, n), 200,
                       nothing)
    library_ms, library = None, f"torch.addmm(c, a, b, alpha={n}, " \
        "out_dtype=float32)"
    try:
        lib = torch.addmm(c, a, b, alpha=n, out_dtype=torch.float32)
        torch.cuda.synchronize()
        library_ms = time_ms(torch, lambda: torch.addmm(
            c, a, b, alpha=n, out_dtype=torch.float32), 200, nothing)
        library += f" (max abs err vs plain {float((lib - want).abs().max())})"
    except (RuntimeError, TypeError, NotImplementedError) as e:
        first = (str(e).splitlines() or [""])[0][:200]
        library += f" is not available here ({type(e).__name__}: {first})"
    dev_ms = device_ms(torch, lambda: probe.listing1(a, b, c, n), 50,
                       nothing)
    spec = probe.KINDS[kind]
    nbytes = sum(t.numel() * t.element_size() for t in (a, b, c, want)) \
        + 2 * 8
    flops = n * 2 * spec.m * spec.n * spec.k
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"listing1 record ({kind}, N={n}): launch {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {library}: "
          + ("not measured" if library_ms is None else f"{library_ms:.4f} ms")
          + f"; bound {bound_ms:.3e} ms ({bound_by}: {nbytes} bytes, {flops} "
          f"flops); the launch's device time "
          + ("not measured" if dev_ms is None else f"{dev_ms:.5f} ms")
          + " (profiler): the event time is the host's launch")
    print(f"listing1 cycles: {json.dumps(cycles)}")
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    return {"name": "listing1", "route": "cuda",
            "source": "src/repro_torch/csrc/listing1.cu",
            "replaces": "src/repro/core/microbench.py:41",
            "launches": counts["listing1"],
            "launches_by_phase": {"21 listing1": counts["listing1"]},
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms,
            "shapes": [{"shape": f"{kind} {spec.ptx} N={n}", "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "max_abs_err": max_abs_err}],
            "cycles": cycles}


# -- phase 22: the performance pipeline over the port's own model -----------

def qwen_step_flops(cfg, B: int, S: int, T: int, *,
                    recompute_kv: bool) -> int:
    """The dot FLOPs of one plain-path step of a dense GQA model: the
    projections at the B * S rows they are applied to (the prefill
    recomputes q, k and v for its cache, ``blocks._attn_prefill_cache``,
    so they count twice there), attention's q.k^T and p.v over T keys per
    query row (the plain path's lengths: the whole cache, masked, for a
    decode step; the prompt in 512-row blocks for a 2048-row prefill),
    and the LM head at each request's last row."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = B * S
    qkv = 2 * rows * D * (H + 2 * KV) * hd
    per_layer = (qkv * (2 if recompute_kv else 1)
                 + 2 * rows * H * hd * D                 # o
                 + 3 * 2 * rows * D * cfg.d_ff           # gate, up, down
                 + 2 * 2 * B * H * S * T * hd)           # q.k^T, p.v
    return cfg.n_layers * per_layer + 2 * B * D * cfg.vocab_size


def phase_perf_pipeline(torch, measured):
    """(a) full-width qwen2-7b's graphs of phase 6's two steps, held to
    the closed form; (b) the H100 roofline against phase 6's device
    times (``measured``, ``phase_sync_profile``'s readings); (c) the
    what-if grid, the five-device sweep and the H100's refusals; (d) the
    phase's wall time."""
    from repro_torch.configs import get_config
    from repro_torch.core.whatif import workload_grid
    from repro_torch.models import decode_step, prefill
    from repro_torch.perf import format_reports, predict, sweep
    from repro_torch.perf.torch_graph import (capture, meta_cache,
                                              meta_params, meta_tokens)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(SERVE["arch"]), use_kernels=False)
    params = meta_params(cfg)
    pf, dc = PERF["prefill"], PERF["decode"]
    graphs = {
        "prefill": capture(prefill, cfg, params,
                           {"tokens": meta_tokens((pf["B"], pf["S"]))},
                           pf["max_len"]),
        "decode": capture(decode_step, cfg, params,
                          meta_cache(cfg, dc["B"], dc["max_len"]),
                          meta_tokens((dc["B"], 1)), dc["pos"]),
    }
    # (a) the plain prefill attends the prompt in 512-row blocks (2048 is
    # a multiple); the decode step the whole max_len cache, masked
    want = {"prefill": qwen_step_flops(cfg, pf["B"], pf["S"], pf["S"],
                                       recompute_kv=True),
            "decode": qwen_step_flops(cfg, dc["B"], 1, dc["max_len"],
                                      recompute_kv=False)}
    for name, g in graphs.items():
        print(f"phase 22 (a): {cfg.name} {name} graph ({cfg.n_layers} "
              f"layers, meta device): {g.flops / 1e9:.3f} GFLOP in "
              f"{len(g.dots)} dot sites "
              f"({sum(op.count for op in g.dots):.0f} calls), "
              f"{g.bytes_accessed / 1e9:.3f} GB moved, of which "
              f"{g.flash_block_bytes / 1e9:.3f} GB attention "
              f"intermediates the kernels keep on chip; closed form "
              f"{want[name] / 1e9:.3f} GFLOP")
        check(g.flops == want[name], f"phase 22: the {name} graph's dot "
              f"FLOPs {g.flops} are not the closed form's {want[name]}")

    # (b)
    for name, g in graphs.items():
        rep = predict(g, device="h100", engine="roofline",
                      workload_name=f"{cfg.name} {name}")
        m = measured[name]
        dev = m["device_ms"]
        kind = "device time" if dev is not None else "wall time (device " \
            "time not measured)"
        got = dev if dev is not None else m["wall_ms"]
        pred = rep.total_time_s * 1e3
        print(f"phase 22 (b): {name} on h100: roofline {pred:.4f} ms "
              f"({rep.bound}-bound: compute {rep.compute_time_s * 1e3:.4f} "
              f"ms, memory {rep.memory_time_s * 1e3:.4f} ms; plan "
              f"{rep.plan_summary()}), phase 6's {kind} {got:.4f} ms on the "
              f"kernel path: {got / pred:.3f}x the roofline")
        check(got >= pred, f"phase 22: the {name} step's measured {kind} "
              f"{got:.4f} ms beats its kernel-adjusted roofline "
              f"{pred:.4f} ms: the graph counts work the kernel path "
              "does not do")

    # (c)
    grid = workload_grid(graphs["prefill"], PERF["grid_device"],
                         engine="mfma", mfma_scale=PERF["scales"])
    times = [r.total_time_s for r in grid.values()]
    print(f"phase 22 (c): mfma what-if on {PERF['grid_device']} (prefill): "
          + ", ".join(f"{k} {r.total_time_s * 1e3:.4f} ms"
                      for k, r in grid.items()))
    check(times[2] == 2 * times[1], f"phase 22: the mfma time on "
          f"{PERF['grid_device']} does not double from mfma_scale 1 to 2: "
          f"{times}")
    reports = sweep({f"{cfg.name} {k}": g for k, g in graphs.items()},
                    devices=PERF["devices"], engines=PERF["engines"])
    print(format_reports(reports))
    for engine in ("mfma", "scoreboard"):
        try:
            predict(graphs["decode"], device="h100", engine=engine)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "roofline" in refused,
              f"phase 22: the {engine} engine priced h100 instead of "
              "raising a ValueError that names the roofline engine")
        print(f"phase 22 (c): {engine} on h100 raises: {refused}")
    wall = time.perf_counter() - t0
    print(f"phase 22: {wall:.1f} s")
    check(wall < PERF["max_s"], f"phase 22 took {wall:.1f} s, over its "
          f"{PERF['max_s']} s")


def draw_params(torch, cfg, seed: int, what: str):
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{what}: {n_params / 1e9:.2f} B params ({cfg.dtype}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB) drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    return params


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: torch is not importable: {e}",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False; this "
              "script measures the port on an NVIDIA GPU and has no CPU "
              "mode", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: FAILED: {ROOT / 'src' / 'repro_torch'} is "
              "missing; run this script from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(label: str) -> None:
        laps.append(time.perf_counter())
        print(f"wall time: {label} {laps[-1] - laps[-2]:.1f} s "
              f"(run so far {laps[-1] - t_start:.1f} s)")

    try:
        resolve_device("cuda")
        card = phase_setup(torch)
        lap("phase 1 (set-up and build)")
        cfg = get_config(SERVE["arch"])
        params = draw_params(torch, cfg, SERVE["seed"],
                             f"{cfg.name} full width, {cfg.n_layers} layers")
        probe = new_engine(cfg, params)
        paged = phase_kernels(torch, cfg, probe.page, probe.nb_table)
        del probe
        flash = flash_records(torch, cfg)
        decode = decode_record(torch, cfg)
        torch.cuda.empty_cache()
        records = {"paged": paged, "flash": flash, "decode": decode}
        for key, rec in records.items():
            rec["shapes"] = [shape_row(rec, f"{cfg.name}: phase 2")]
            rec["launches_by_phase"] = {}
        lap("phase 2 (kernel checks)")
        launches, reqs, paged_results = phase_serve(torch, cfg, params)
        paged["launches_by_phase"]["3 " + cfg.name] = \
            launches["paged_decode_attention"]
        launches = phase_sync_serve(torch, cfg, params)
        flash["launches_by_phase"]["4 " + cfg.name] = launches["flash_attention"]
        decode["launches_by_phase"]["4 " + cfg.name] = \
            launches["decode_attention"]
        phase_engines(torch, cfg, params, reqs, paged_results)
        phase_profile(torch, cfg, params, serve_trace(cfg.vocab_size))
        sync_readings = phase_sync_profile(torch, cfg, params)
        del params
        torch.cuda.empty_cache()
        lap("phases 3-6 (qwen2-7b)")

        full = get_config(MOE["arch"])
        moe_cfg = dataclasses.replace(full, n_layers=MOE["n_layers"])
        moe = moe_gmm_record(torch, moe_cfg)
        moe["launches_by_phase"] = {}
        records["moe"] = moe
        torch.cuda.reset_peak_memory_stats()
        params = draw_params(
            torch, moe_cfg, MOE["seed"],
            f"{moe_cfg.name} full width (d_model {moe_cfg.d_model}, "
            f"{moe_cfg.n_heads} query heads over {moe_cfg.n_kv_heads} KV "
            f"heads of {moe_cfg.hd}, {moe_cfg.moe.n_experts} experts top-"
            f"{moe_cfg.moe.top_k} of width {moe_cfg.moe.d_ff_expert}, vocab "
            f"{moe_cfg.vocab_size}) cut in depth from {full.n_layers} to "
            f"{moe_cfg.n_layers} layers (dataclasses.replace(cfg, "
            f"n_layers={MOE['n_layers']}))")
        launches, routing = phase_moe_serve(torch, moe_cfg, params)
        moe["launches_by_phase"]["8 " + moe_cfg.name] = launches["moe_gmm"]
        launches, routing_sync = phase_moe_sync(torch, moe_cfg, params)
        moe["launches_by_phase"]["9 " + moe_cfg.name] = launches["moe_gmm"]
        phase_moe_profile(torch, moe_cfg, params)
        print(f"MoE phases: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; routing "
              f"flips (paged tick, sync step): {routing}, {routing_sync}")
        del params
        torch.cuda.empty_cache()
        lap("phases 7-10 (qwen3-moe)")

        ssd = ssd_record(torch)
        ssm_cfg = get_config(SSM["arch"])
        params = draw_params(
            torch, ssm_cfg, SSM["seed"],
            f"{ssm_cfg.name} full width and depth ({ssm_cfg.n_layers} SSM "
            f"layers, d_model {ssm_cfg.d_model}, "
            f"{2 * ssm_cfg.d_model // ssm_cfg.ssm.head_dim} heads of "
            f"{ssm_cfg.ssm.head_dim}, d_state {ssm_cfg.ssm.d_state}, vocab "
            f"{ssm_cfg.vocab_size}, tied embeddings)")
        launches = phase_ssm_sync(torch, ssm_cfg, params)
        ssd_launches = launches["mamba2_ssd"]
        phase_ssm_profile(torch, ssm_cfg, params)
        del params
        torch.cuda.empty_cache()
        lap("phases 11-13 (mamba2)")

        full = get_config(HYBRID["arch"])
        hyb_cfg = dataclasses.replace(full, n_layers=HYBRID["n_layers"])
        torch.cuda.reset_peak_memory_stats()
        params = draw_params(
            torch, hyb_cfg, HYBRID["seed"],
            f"{hyb_cfg.name} full width (d_model {hyb_cfg.d_model}, "
            f"{hyb_cfg.n_heads} query heads over {hyb_cfg.n_kv_heads} KV heads "
            f"of {hyb_cfg.hd}, {hyb_cfg.moe.n_experts} experts top-"
            f"{hyb_cfg.moe.top_k} of width {hyb_cfg.moe.d_ff_expert}, SSM "
            f"d_state {hyb_cfg.ssm.d_state}, vocab {hyb_cfg.vocab_size}) cut "
            f"in depth from {full.n_layers} to {hyb_cfg.n_layers} layers "
            f"(dataclasses.replace(cfg, n_layers={HYBRID['n_layers']}); "
            f"{n_ssm_layers(hyb_cfg)} SSM layers, attention at "
            f"{[i for i in range(hyb_cfg.n_layers) if hyb_cfg.layer_kind(i) == 'attn']})")
        launches, routing_hyb = phase_hybrid_sync(torch, hyb_cfg, params)
        ssd["launches"] = ssd_launches + launches["mamba2_ssd"]
        print(f"hybrid phase: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; routing "
              f"flips (sync step): {routing_hyb}")
        del params
        torch.cuda.empty_cache()
        lap("phase 14 (jamba)")

        gemm, gemm_rows = gemm_records(torch)
        gemm["launches"] = phase_mfma_contract(torch)
        print(f"mfma_gemm timed shapes: {json.dumps(gemm_rows)}")
        lap("phase 15 (the MFMA contract)")

        phase_dense_catalog(torch, records)
        lap("phase 16 (the dense catalog)")
        phase_mla(torch, records)
        lap("phase 17 (deepseek-v2-lite-16b)")
        phase_vlm(torch, records)
        lap("phase 18 (llama-3.2-vision-90b)")
        phase_encoder(torch, records)
        lap("phase 19 (whisper-base)")
        phase_train(torch)
        lap("phase 20 (training)")
        listing1 = phase_timing_model(torch)
        lap("phase 21 (the timing model and the Listing-1 probe)")
        phase_perf_pipeline(torch, sync_readings)
        lap("phase 22 (the performance pipeline)")
        for rec in records.values():
            rec["launches"] = sum(rec["launches_by_phase"].values())
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                r["max_abs_err"] for r in rec["shapes"]])
        check(not DEFERRED, "; ".join(DEFERRED))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"elapsed {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [paged, flash, decode, moe, ssd, gemm,
                                  listing1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
