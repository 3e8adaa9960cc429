"""The CUDA kernels on the card, against their plain PyTorch versions,
and both serve engines on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU mode).  This file imports neither jax nor the
reference, so it runs on a GPU machine with only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: bfloat16 atol 1e-2 (about one bf16 ulp at the outputs'
magnitude; a kernel and its plain version round at the same points but
sum in different orders, and the flash and contiguous decode kernels
carry p as two halves in its dtype, within 2**-16 of the plain version's
f32 p), plus rtol 2**-7 (one bf16 ulp at any
magnitude) for the flash and decode kernels, whose outputs
reach |x| >= 2 where an ulp is 2**-6 (the first paged-decode test keeps
rtol 0: its outputs stay below 2); float16 atol 1e-3 plus rtol 2**-10
(one f16 ulp); float32 atol 1e-5 (1e-4 for flash
attention, whose sums run over up to 4100 keys).  The MoE grouped GEMM:
bfloat16 atol 1e-2 plus rtol 2**-7 (both round the same f32 sums once,
summed in different orders); float32 atol 2e-3 plus rtol 1e-5 (sums of
up to 4096 products, outputs up to ~300 in magnitude).  The SSD scan:
y in float32 atol 1e-3 plus rtol 1e-4 (f32 sums over up to 64 chunk rows
and ds state columns, carried through exp of the cumulative decay, in
other orders than the plain version's), in bfloat16 atol 1e-2 plus rtol
2**-7 (both round the same f32 value once); the f32 state atol 1e-3
plus rtol 1e-4 in both.  The MFMA GEMM, by C's dtype: float32 atol 1e-3
plus rtol 1e-4 (the same exact products summed over up to 1032 terms in
another order, and on the tensor cores with their own f32 accumulation
rounding), bfloat16 atol 1e-2 plus rtol 2**-7 and float16 atol 1e-3 plus
rtol 2**-10 (one ulp of C's dtype: both round one f32 sum once).  The
Listing-1 probe: exact (integer-valued operands make every sum exact).
"""

import dataclasses
import importlib
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import isa
from repro_torch.core.functional import mfma_apply, random_operands
from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 flash_attention, flash_attention_plain,
                                 launch_counts, mamba2_ssd,
                                 mamba2_ssd_plain, mfma_gemm,
                                 mfma_gemm_plain, moe_gmm, moe_gmm_plain,
                                 paged_decode_attention,
                                 paged_decode_attention_plain,
                                 reset_launch_counts)
from repro_torch.kernels.decode_attention import kernel_split_rows
from repro_torch.models import init_params
from repro_torch.serve import OK, PagedServeEngine, ServeEngine, get_trace
from repro_torch.serve.parity import divergences

ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
        torch.float16: 2.0 ** -10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(G, page, hd, dtype, *, KV=4, B=5, seed=0):
    """Ragged lengths (two pages and a partial third, one page, one page
    plus a row, a single row, an idle slot on the poisoned null block)."""
    g = torch.Generator().manual_seed(seed)
    NB = 3
    P = B * NB + 1
    q = torch.randn((B, G * KV, hd), generator=g)
    kp = torch.randn((P, page, KV, hd), generator=g)
    vp = torch.randn((P, page, KV, hd), generator=g)
    kp[0], vp[0] = 40.0, -40.0
    lens = [2 * page + 5, page, page + 1, 1, 1][:B]
    tables = torch.zeros((B, NB), dtype=torch.int32)
    for b, n in enumerate(lens[:-1]):
        used = math.ceil(n / page)
        tables[b, :used] = torch.arange(1 + b * NB, 1 + b * NB + used)
    return ([t.to(dtype).cuda() for t in (q, kp, vp)]
            + [tables.cuda(), torch.tensor(lens, dtype=torch.int32).cuda()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,page,hd", [(1, 16, 32), (2, 128, 32),
                                       (7, 64, 128), (8, 32, 256)])
def test_kernel_matches_plain(cuda, G, page, hd, dtype):
    args = _case(G, page, hd, dtype, seed=G)
    before = launch_counts()["paged_decode_attention"]
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode_attention"] == before + 1
    want = paged_decode_attention_plain(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=ATOL[dtype])


@pytest.mark.cuda
def test_engine_kernel_path_matches_plain_path(cuda):
    """The reduced qwen2-7b served on the card: the kernel path launches
    once per layer per decode tick and its greedy streams match the
    plain path's up to near-ties."""
    cfg = get_config("qwen2-7b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    reqs = get_trace("base")(6, cfg.vocab_size, seed=1)
    kernel = PagedServeEngine(cfg, params, max_len=128, max_batch=4)
    plain = PagedServeEngine(dataclasses.replace(cfg, use_kernels=False),
                             params, max_len=128, max_batch=4)
    before = launch_counts()["paged_decode_attention"]
    k_res, k_stats = kernel.run(reqs)
    assert launch_counts()["paged_decode_attention"] - before == \
        cfg.n_layers * k_stats.decode_steps
    p_res, p_stats = plain.run(reqs)
    assert [r.status for r in k_res] == [OK] * len(reqs)
    assert k_stats.ticks == p_stats.ticks
    assert all(d["accepted"] for d in divergences(plain, reqs, p_res, k_res))


def _paged_split_case(g, G, page, dtype, lens, *, KV=4, hd=128, T=704):
    """A pool whose tables hold T rows (several of the kernel's splits),
    requests of ``lens`` rows, the idle ones (length 1) on null block 0,
    which holds finite poison; rows past a length in a request's own
    pages are NaN and must never be read."""
    B, NB = len(lens), -(-T // page)
    P = 1 + B * NB
    q = _randn(g, B, G * KV, hd)
    kp, vp = _randn(g, P, page, KV, hd), _randn(g, P, page, KV, hd)
    kp[0], vp[0] = 40.0, -40.0
    tables = torch.zeros((B, NB), dtype=torch.int32)
    for b, n in enumerate(lens):
        if n == 1:
            continue                                  # idle: all null
        used = -(-n // page)
        tables[b, :used] = torch.arange(1 + b * NB, 1 + b * NB + used)
        last, tail = 1 + b * NB + used - 1, n - (used - 1) * page
        kp[last, tail:], vp[last, tail:] = float("nan"), float("nan")
    return ([t.to(dtype).cuda() for t in (q, kp, vp)]
            + [tables.cuda(), torch.tensor(lens, dtype=torch.int32).cuda()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("page", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 7, 16])
def test_paged_kernel_splits_back_to_back(cuda, G, page, dtype):
    """The split paged kernel over a 704-row table (several splits of
    kernel_split_rows rows, each crossing pages at 16 and 64 rows),
    ragged lengths and an idle slot on block 0, launched twice back to
    back on one stream with other lengths and pools: the second launch
    finds the tickets the first reset and reuses its scratch.  One
    count per launch; both equal the plain version."""
    g = torch.Generator().manual_seed(G * page)
    first = _paged_split_case(g, G, page, dtype, [700, 1, 129, 64, 333])
    second = _paged_split_case(g, G, page, dtype, [1, 256, 700, 17, 640])
    before = launch_counts()["paged_decode_attention"]
    got = [paged_decode_attention(*first), paged_decode_attention(*second)]
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode_attention"] == before + 2
    for out, args in zip(got, (first, second)):
        want = paged_decode_attention_plain(*args)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=RTOL[dtype], atol=ATOL[dtype])


def _randn(g, *shape):
    return torch.randn(shape, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd,S,T,causal,kv_len", [
    (1, 32, 64, 64, True, None),
    (2, 64, 200, 200, True, None),
    (7, 128, 130, 130, True, 100),
    (7, 128, 70, 300, False, 257),
    (2, 32, 1, 65, False, None),
    (4, 128, 200, 200, True, None),       # jamba's grouping
    (16, 128, 300, 300, True, 257),       # qwen3-moe's grouping
    (16, 64, 130, 200, False, None),
])
def test_flash_kernel_matches_plain(cuda, G, hd, S, T, causal, kv_len,
                                    dtype):
    g = torch.Generator().manual_seed(G * hd + S)
    B, KV = 2, 4
    q, k, v = (_randn(g, B, S, G * KV, hd), _randn(g, B, T, KV, hd),
               _randn(g, B, T, KV, hd))
    n = T if kv_len is None else kv_len
    k[:, n:], v[:, n:] = float("nan"), float("inf")   # never read
    q, k, v = (t.to(dtype).cuda() for t in (q, k, v))
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    assert torch.isfinite(got).all()
    atol = 1e-4 if dtype == torch.float32 else ATOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=RTOL[dtype],
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd,T,per_request", [
    (1, 32, 64, True), (2, 64, 200, False), (7, 128, 300, True),
    (8, 256, 130, True),
    (4, 128, 300, True),        # jamba's grouping
    (16, 128, 300, True),       # qwen3-moe's: one full A fragment
    (20, 96, 200, True),        # two A fragments, the second 4 heads
    (7, 160, 300, False),
])
def test_decode_kernel_matches_plain(cuda, G, hd, T, per_request, dtype):
    g = torch.Generator().manual_seed(G * hd + T)
    B, KV = 5, 4
    q = _randn(g, B, G * KV, hd)
    k, v = _randn(g, B, T, KV, hd), _randn(g, B, T, KV, hd)
    lens = [T, 1, 64, 65, T - 7][:B]
    for b, n in enumerate(lens if per_request else [T - 9] * B):
        k[b, n:], v[b, n:] = float("nan"), float("inf")  # never read
    q, k, v = (t.to(dtype).cuda() for t in (q, k, v))
    kv_len = torch.tensor(lens, dtype=torch.int32).cuda() if per_request \
        else T - 9
    before = launch_counts()["decode_attention"]
    got = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == before + 1
    want = decode_attention_plain(q, k, v, kv_len)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=RTOL[dtype],
                               atol=ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,T", [(1, 7, 2048), (6, 7, 2048), (6, 16, 700)])
def test_decode_kernel_split_edges(cuda, B, G, T, dtype):
    """Lengths at the edges of the kernel's splits (kernel_split_rows):
    0, 1, R, R + 1, 2 R - 1 and T, and B = 1 over a long cache (2000 of
    2048 rows: the run(batch=1) step).  Rows past a length are never
    read."""
    KV, hd = 4, 128
    R = kernel_split_rows(T, B * KV)
    edges = [2000] if B == 1 else [0, 1, R, R + 1, 2 * R - 1, T]
    g = torch.Generator().manual_seed(B * T + G)
    q = _randn(g, B, G * KV, hd)
    k, v = _randn(g, B, T, KV, hd), _randn(g, B, T, KV, hd)
    for b, n in enumerate(edges):
        k[b, n:], v[b, n:] = float("nan"), float("inf")
    q, k, v = (t.to(dtype).cuda() for t in (q, k, v))
    lens = torch.tensor(edges, dtype=torch.int32).cuda()
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, lens)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=RTOL[dtype],
                               atol=ATOL[dtype])


@pytest.mark.cuda
def test_decode_kernel_scratch_kept_per_stream(cuda):
    """The wrapper keeps its split state and tickets per stream and grows
    them: small, large, then small again on one stream, and one call on a
    second stream, each equal to the plain version."""
    KV, hd = 4, 128
    g = torch.Generator().manual_seed(5)
    side = torch.cuda.Stream()
    for B, G, T, stream in [(1, 7, 256, None), (8, 16, 2048, None),
                            (2, 7, 512, None), (8, 16, 2048, side)]:
        q = _randn(g, B, G * KV, hd).to(torch.bfloat16).cuda()
        k = _randn(g, B, T, KV, hd).to(torch.bfloat16).cuda()
        v = _randn(g, B, T, KV, hd).to(torch.bfloat16).cuda()
        lens = torch.randint(0, T + 1, (B,), generator=g, dtype=torch.int32
                             ).cuda()
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            if stream is not None:
                stream.wait_stream(torch.cuda.default_stream())
            got = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        want = decode_attention_plain(q, k, v, lens)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=RTOL[torch.bfloat16],
                                   atol=ATOL[torch.bfloat16])


@pytest.mark.cuda
def test_sync_engine_kernel_path_matches_plain_path(cuda):
    """The reduced qwen2-7b served by the sync engine on the card: one
    flash launch per layer per prefill, one decode launch per layer per
    decode step, and greedy streams equal to the plain path's up to
    near-ties; the paged engine agrees with it up to near-ties too."""
    cfg = get_config("qwen2-7b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    reqs = get_trace("base")(5, cfg.vocab_size, seed=1)
    kernel = ServeEngine(cfg, params, max_len=128)
    plain = ServeEngine(dataclasses.replace(cfg, use_kernels=False), params,
                        max_len=128)
    reset_launch_counts()
    k_res, k_stats = kernel.run(reqs)
    counts = launch_counts()
    assert counts["flash_attention"] == cfg.n_layers * len(reqs)
    assert counts["decode_attention"] == cfg.n_layers * k_stats.decode_steps
    p_res, _ = plain.run(reqs)
    assert all(d["accepted"] for d in divergences(plain, reqs, p_res, k_res))
    paged, _ = PagedServeEngine(cfg, params, max_len=128,
                                max_batch=4).run(reqs)
    assert all(d["accepted"] for d in divergences(kernel, reqs, k_res,
                                                  paged))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,K,N,offset", [
    (4, 20, 100, 60, 0),        # capacity-trimmed C, ragged K and N
    (3, 44, 37, 129, 0),        # K, N not multiples of a 16-byte load
    (2, 8, 4096, 64, 0),        # decode-like depth
    (1, 130, 64, 200, 0),       # three row tiles, ragged column tile
    (2, 12, 64, 64, 1),         # operands not 16-byte aligned
])
def test_moe_gmm_kernel_matches_plain(cuda, E, C, K, N, offset, dtype):
    g = torch.Generator().manual_seed(E * C + K + N)

    def operand(*shape):
        flat = _randn(g, math.prod(shape) + offset).to(dtype).cuda()
        return flat[offset:].view(shape)

    x, w = operand(E, C, K), operand(E, K, N)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = launch_counts()["moe_gmm"]
    got = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["moe_gmm"] == before + 1
    want = moe_gmm_plain(x, w)
    assert torch.isfinite(got).all() and got.dtype == dtype
    atol = 2e-3 if dtype == torch.float32 else ATOL[dtype]
    rtol = 1e-5 if dtype == torch.float32 else RTOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def _moe_operands(g, E, C, K, N, dtype, offset=0):
    def operand(*shape, scale=1.0):
        flat = (_randn(g, math.prod(shape) + offset) * scale).to(dtype)
        return flat.cuda()[offset:].view(shape)

    return operand(E, C, K), operand(E, K, N, scale=1 / math.sqrt(K))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C", [4, 16, 32, 44, 160])
def test_moe_gmm_ring_row_tiles(cuda, C, dtype):
    """The tensor-core ring at the capacities of the serving paths, each
    on its row tile (16, 32, 64, 128 rows; C = 160 takes two tiles of
    128), K = 264 (a ragged last 32-deep slice) and N = 392 (a ragged
    last 128-column tile): one count per call, equal to the plain
    version."""
    g = torch.Generator().manual_seed(C)
    x, w = _moe_operands(g, 3, C, 264, 392, dtype)
    before = launch_counts()["moe_gmm"]
    got = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["moe_gmm"] == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               moe_gmm_plain(x, w).float().cpu().numpy(),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("N,offset", [(100, 0), (128, 1)],
                         ids=["n_not_multiple_of_8", "offset_pointer"])
def test_moe_gmm_cuda_core_path(cuda, N, offset, dtype):
    """16-bit operands the ring does not take (N not a multiple of 8, a
    pointer off 16-byte alignment) run on the CUDA-core kernel at the
    decode capacity: one count per call, equal to the plain version."""
    g = torch.Generator().manual_seed(N + offset)
    x, w = _moe_operands(g, 2, 32, 64, N, dtype, offset)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = launch_counts()["moe_gmm"]
    got = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["moe_gmm"] == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               moe_gmm_plain(x, w).float().cpu().numpy(),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.cuda
def test_moe_engines_kernel_path_matches_plain_path(cuda):
    """The reduced qwen3-moe served on the card by both engines: three
    moe_gmm launches per layer per step (paged: decode ticks and prefill
    chunks; sync: prefills and decode steps), every request OK, and the
    greedy streams equal to the plain path's up to logit or routing
    near-ties."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    reqs = get_trace("base")(5, cfg.vocab_size, seed=1)
    paged = PagedServeEngine(cfg, params, max_len=128, max_batch=4)
    reset_launch_counts()
    k_res, k_stats = paged.run(reqs)
    assert launch_counts()["moe_gmm"] == 3 * cfg.n_layers * (
        k_stats.decode_steps + k_stats.prefill_chunks)
    assert [r.status for r in k_res] == [OK] * len(reqs)
    plain = PagedServeEngine(plain_cfg, params, max_len=128, max_batch=4)
    p_res, _ = plain.run(reqs)
    assert all(d["accepted"] for d in divergences(
        plain, reqs, p_res, k_res, engine=paged))
    sync = ServeEngine(cfg, params, max_len=128)
    reset_launch_counts()
    s_res, s_stats = sync.run(reqs)
    assert launch_counts()["moe_gmm"] == 3 * cfg.n_layers * (
        len(reqs) + s_stats.decode_steps)
    plain = ServeEngine(plain_cfg, params, max_len=128)
    p_res, _ = plain.run(reqs)
    assert all(d["accepted"] for d in divergences(
        plain, reqs, p_res, s_res, engine=sync))


def _moe_on_capacity_buffers(cfg, w, x):
    """``moe_apply``'s routing, products and combine (no shared experts)
    on slot buffers of the full capacity C rows an expert a group, the
    reference's layout, every product through ``moe_gmm``."""
    from repro_torch.models import moe
    F = torch.nn.functional
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = moe.capacity(cfg, S)
    gates, idx, _ = moe.router_topk(cfg, w["router"], x)
    idx = idx.reshape(B, S * K)
    pos, keep, src, used = moe._slot_maps(cfg, idx, C)
    xbuf = torch.gather(x, 1, (src // K)[..., None].expand(-1, -1, D)) \
        * used[..., None].to(x.dtype)
    xe = xbuf.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    h = (F.silu(moe_gmm(xe, w["we_g"]).float())
         * moe_gmm(xe, w["we_i"]).float()).to(x.dtype)
    ybuf = moe_gmm(h, w["we_o"]).reshape(E, B, C, D).transpose(0, 1)
    slot = torch.where(keep, idx * C + pos, 0)
    y_k = torch.gather(ybuf.reshape(B, E * C, D), 1,
                       slot[..., None].expand(-1, -1, D))
    gk = (gates.reshape(B, S * K) * keep.float()).to(x.dtype)
    return (y_k * gk[..., None]).reshape(B, S, K, D).sum(dim=2), C


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 128])
def test_moe_decode_one_row_buffers_equal_capacity_buffers(cuda, B):
    """The reduced qwen3-moe's decode step (B one-token groups, capacity
    4): ``moe_apply``'s one-row slot buffers give, bit for bit, what the
    three products give on the capacity's 4-row buffers through
    ``moe_gmm``, in three launches."""
    from repro_torch.models import moe
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    g = torch.Generator(device="cuda").manual_seed(B)
    w = moe.init_moe(cfg, g, cuda)
    x = torch.randn((B, 1, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    before = launch_counts()["moe_gmm"]
    y, _ = moe.moe_apply(cfg, w, x)
    torch.cuda.synchronize()
    assert launch_counts()["moe_gmm"] == before + 3
    want, C = _moe_on_capacity_buffers(cfg, w, x)
    assert C == 4
    assert torch.equal(y, want), int((y != want).sum())


@pytest.mark.cuda
def test_paged_decode_runs_one_row_buffers(cuda):
    """The paged engine on the reduced qwen3-moe: three ``moe_gmm``
    launches a layer a step, and every decode step's dispatch records
    one-row buffers under a capacity of 4."""
    from repro_torch import trace
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    reqs = get_trace("base")(8, cfg.vocab_size, seed=2)
    paged = PagedServeEngine(cfg, params, max_len=128, max_batch=8)
    reset_launch_counts()
    trace.clear()
    with trace.recording():
        res, stats = paged.run(reqs)
    assert launch_counts()["moe_gmm"] == 3 * cfg.n_layers * (
        stats.decode_steps + stats.prefill_chunks)
    assert [r.status for r in res] == [OK] * len(reqs)
    decode = [r.attrs for r in trace.records()
              if r.name == "moe.dispatch" and r.attrs["B"] == 8]
    trace.clear()
    assert len(decode) == cfg.n_layers * stats.decode_steps
    assert all((a["C"], a["capacity"]) == (1, 4) for a in decode), decode


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,G,ds,offset", [
    (1, 64, 2, 16, 1, 16, 0),       # one row tile of a chunk
    (2, 200, 4, 32, 2, 16, 0),      # ragged S, two groups
    (1, 130, 8, 64, 1, 128, 0),     # mamba2's head and state size, ragged
    (2, 52, 4, 64, 2, 64, 0),       # shorter than a chunk
    (1, 333, 4, 16, 4, 32, 0),      # one head per group
    (1, 100, 4, 64, 1, 128, 1),     # operands not 16-byte aligned
    (1, 300, 2, 96, 1, 32, 0),      # hd 96: a full and a partial 64-column block
])
def test_mamba2_ssd_kernel_matches_plain(cuda, B, S, nh, hd, G, ds, offset,
                                         dtype):
    _ssd_case(B, S, nh, hd, G, ds, offset, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 256, 257])
def test_mamba2_ssd_chunk_edges(cuda, S, dtype):
    """S at the edges of the kernels' 128-row chunks and 64-row tiles,
    at mamba2's head and state size with two groups: one count per call,
    y and the final state equal to the plain version's."""
    _ssd_case(1, S, 4, 64, 2, 128, 0, dtype)


def _ssd_case(B, S, nh, hd, G, ds, offset, dtype):
    g = torch.Generator().manual_seed(S + ds + G)

    def operand(shape, dt, scale=0.5):
        flat = (_randn(g, math.prod(shape) + offset) * scale).to(dt).cuda()
        return flat[offset:].view(shape)

    x = operand((B, S, nh, hd), dtype)
    dt = operand((B, S, nh), torch.float32).abs() * 0.8 + 0.05
    A = -operand((nh,), torch.float32, 1.0).abs() - 0.1
    Bm, Cm = operand((B, S, G, ds), dtype), operand((B, S, G, ds), dtype)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = launch_counts()["mamba2_ssd"]
    y, h = mamba2_ssd(x, dt.contiguous(), A.contiguous(), Bm, Cm)
    torch.cuda.synchronize()
    assert launch_counts()["mamba2_ssd"] == before + 1
    want_y, want_h = mamba2_ssd_plain(x, dt, A, Bm, Cm)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert y.dtype == dtype and h.dtype == torch.float32
    f32 = dtype == torch.float32
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want_y.float().cpu().numpy(),
                               rtol=1e-4 if f32 else RTOL[dtype],
                               atol=1e-3 if f32 else ATOL[dtype])
    np.testing.assert_allclose(h.cpu().numpy(), want_h.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_mamba2_ssd_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 8, 4, 64), device="cuda")
    dt = torch.zeros((1, 8, 4), device="cuda")
    A = -torch.ones((4,), device="cuda")
    Bm = torch.zeros((1, 8, 1, 128), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                   Bm, Bm)
    with pytest.raises(ValueError, match="ds=24"):
        mamba2_ssd(x, dt, A, Bm[..., :24].contiguous(),
                   Bm[..., :24].contiguous())
    with pytest.raises(ValueError, match="on cuda"):
        mamba2_ssd(x, dt.cpu(), A, Bm, Bm)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_ssm_sync_engine_kernel_path_matches_plain_path(cuda, arch):
    """The reduced mamba2 and jamba served by the sync engine on the card:
    two mamba2_ssd launches per SSM layer per prefill (the layer's output
    and the state it hands to decode), one flash launch per attention
    layer per prefill, and greedy streams equal to the plain path's up
    to near-ties (jamba: or routing near-ties)."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
    reqs = get_trace("base")(4, cfg.vocab_size, seed=1)
    kernel = ServeEngine(cfg, params, max_len=128)
    reset_launch_counts()
    k_res, k_stats = kernel.run(reqs)
    counts = launch_counts()
    assert counts["mamba2_ssd"] == 2 * n_ssm * len(reqs)
    assert counts["flash_attention"] == (cfg.n_layers - n_ssm) * len(reqs)
    assert counts["decode_attention"] == \
        (cfg.n_layers - n_ssm) * k_stats.decode_steps
    plain = ServeEngine(dataclasses.replace(cfg, use_kernels=False), params,
                        max_len=128)
    p_res, _ = plain.run(reqs)
    assert all(d["accepted"] for d in divergences(
        plain, reqs, p_res, k_res, engine=kernel))


GEMM_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (1e-2, 2.0 ** -7),
            torch.float16: (1e-3, 2.0 ** -10)}
GEMM_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", GEMM_DTYPES)
@pytest.mark.parametrize("ab_dtype", GEMM_DTYPES)
@pytest.mark.parametrize("M,N,K,offset", [
    (100, 60, 200, 0),      # ragged M, N and K (N % 8 != 0: element loads)
    (130, 136, 64, 0),      # K and N multiples of 8: wgmma fed by TMA
    (200, 264, 520, 0),     # wgmma: ragged tiles, a partial last slice
    (8, 256, 1032, 0),      # the decode path, split over K (17 slices)
    (8, 72, 300, 1),        # decode-like rows; a, b and c not aligned
])
def test_mfma_gemm_kernel_matches_plain(cuda, M, N, K, offset, ab_dtype,
                                        c_dtype):
    g = torch.Generator().manual_seed(M + N + K)

    def operand(shape, dt):
        flat = _randn(g, math.prod(shape) + offset).to(dt).cuda()
        return flat[offset:].view(shape)     # a contiguous view at offset

    a, b = operand((M, K), ab_dtype), operand((K, N), ab_dtype)
    c = operand((M, N), c_dtype)
    assert (a.data_ptr() % 16 != 0) == bool(offset)
    before = launch_counts()["mfma_gemm"]
    got = mfma_gemm(a, b, c)
    torch.cuda.synchronize()
    assert launch_counts()["mfma_gemm"] == before + 1
    want = mfma_gemm_plain(a, b, c)
    assert torch.isfinite(got).all() and got.dtype == c_dtype
    atol, rtol = GEMM_TOL[c_dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def _gemm_operands(g, M, N, K, ab_dtype, c_dtype):
    a = _randn(g, M, K).to(ab_dtype).cuda()
    b = (_randn(g, K, N) / math.sqrt(K)).to(ab_dtype).cuda()
    return a, b, _randn(g, M, N).to(c_dtype).cuda()


def _gemm_held_to_plain(a, b, c):
    before = launch_counts()["mfma_gemm"]
    got = mfma_gemm(a, b, c)
    torch.cuda.synchronize()
    assert launch_counts()["mfma_gemm"] == before + 1
    want = mfma_gemm_plain(a, b, c)
    assert torch.isfinite(got).all() and got.dtype == c.dtype
    atol, rtol = GEMM_TOL[c.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 72])
@pytest.mark.parametrize("N", [8, 264])
@pytest.mark.parametrize("M", [1, 65, 130, 257])
def test_mfma_gemm_tile_edges(cuda, M, N, K):
    """bf16 operands with K and N multiples of 8, off every tile edge:
    M = 1 on the decode path, M 65, 130 and 257 on the wgmma path (1, 2
    and 3 row tiles of 128, the last nearly empty), N 8 and 264 (a box of
    B mostly past N, and a second column tile of 8), K 8 and 72 (one
    slice mostly past K, and a partial second)."""
    g = torch.Generator().manual_seed(M * N + K)
    _gemm_held_to_plain(*_gemm_operands(g, M, N, K, torch.bfloat16,
                                        torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", GEMM_DTYPES)
def test_mfma_gemm_wgmma_c_off_pairs(cuda, c_dtype):
    """The wgmma path (aligned a and b) with c one element off, so that
    its pairs of C are not aligned for one access: C is read and D
    written element by element, and both equal the plain version."""
    g = torch.Generator().manual_seed(17)
    a, b, _ = _gemm_operands(g, 130, 264, 72, torch.bfloat16, c_dtype)
    c = _randn(g, 130 * 264 + 1).to(c_dtype).cuda()[1:].view(130, 264)
    assert c.data_ptr() % (2 * c.element_size()) != 0
    _gemm_held_to_plain(a, b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("c_dtype", GEMM_DTYPES)
@pytest.mark.parametrize("ab_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M,N,K", [
    (8, 8192, 512),     # 128 column tiles: split over K in two
    (33, 2048, 4096),   # 48 rows of fragments, 32 tiles: eight splits
    (64, 18944, 256),   # K of four slices: no split
])
def test_mfma_gemm_decode_path(cuda, M, N, K, ab_dtype, c_dtype):
    """The decode path (M <= 64) at each row-fragment count, with and
    without its split over K; the split scratch and tickets are reused
    across the calls on one stream."""
    g = torch.Generator().manual_seed(M + N + K)
    for _ in range(2):
        _gemm_held_to_plain(*_gemm_operands(g, M, N, K, ab_dtype, c_dtype))


@pytest.mark.cuda
def test_mfma_gemm_library_runs_hgmma(cuda):
    """The built library holds wgmma instructions (HGMMA in its SASS)."""
    import shutil
    import subprocess
    from pathlib import Path
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or next(
        (str(Path(r) / "bin" / "cuobjdump") for r in
         (os.environ.get("CUDA_HOME"), "/usr/local/cuda")
         if r and (Path(r) / "bin" / "cuobjdump").is_file()), None)
    if tool is None:
        pytest.skip("cuobjdump is not installed")
    build.load("mfma_gemm")
    sass = subprocess.run([tool, "-sass", str(build.library_path(
        "mfma_gemm"))], capture_output=True, text=True, check=True).stdout
    assert "HGMMA" in sass


@pytest.mark.cuda
@pytest.mark.parametrize("ab_dtype", GEMM_DTYPES)
def test_mfma_gemm_accumulates_c_exactly(cuda, ab_dtype):
    """Integer-valued operands make every product and partial sum exact
    in f32, so C = 3 and C = 0 must give outputs exactly 3 apart."""
    g = torch.Generator().manual_seed(11)
    a = torch.randint(-4, 5, (96, 200), generator=g).to(ab_dtype).cuda()
    b = torch.randint(-4, 5, (200, 72), generator=g).to(ab_dtype).cuda()
    c0 = torch.zeros((96, 72), device="cuda")
    d = mfma_gemm(a, b, c0 + 3.0) - mfma_gemm(a, b, c0)
    assert bool((d == 3.0).all())


@pytest.mark.cuda
def test_mfma_gemm_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((64, 32), device="cuda", dtype=torch.bfloat16)
    c = torch.zeros((64, 16), device="cuda")
    with pytest.raises(ValueError, match="incompatible operands"):
        mfma_gemm(a, a, c)
    with pytest.raises(ValueError, match="on cuda"):
        mfma_gemm(a, a[:32, :16].contiguous(), c.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        mfma_gemm(a, a.t()[:, :16], c)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, i in isa.MFMA_REGISTRY.items()
                                  if i.in_dtype in ("i8", "fp8")])
def test_mfma_apply_on_the_card_matches_the_cpu(cuda, name):
    """i8 instructions accumulate exactly into int32 on the card too (the
    product is formed in float64, exact at these magnitudes); fp8
    operands are cast to f32 before the product, as on the CPU."""
    a, b, c = random_operands(name, seed=5, device="cuda")
    got = mfma_apply(name, a, b, c)
    want = mfma_apply(name, a.cpu(), b.cpu(), c.cpu())
    assert got.device.type == "cuda" and got.dtype == want.dtype
    if isa.lookup(name).out_dtype == "i32":
        assert torch.equal(got.cpu(), want)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)


# -- the catalog's new shapes (internlm2's G = 6, vision's cross layers over
# 4100 media rows, whisper's encoder over 1500 frames, deepseek's experts) --

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,KV,hd,S,T", [
    (8, 2, 128, 517, 4100),     # vision cross layers: S != T, T % 64 = 4
    (8, 2, 128, 1, 4100),       # a one-token prompt's cross layer
    (1, 8, 64, 1500, 1500),     # whisper's encoder, S = T = 1500
    (1, 8, 64, 700, 1500),      # hd 64 with S != T
    (8, 2, 128, 130, 77),       # fewer keys than queries
])
def test_flash_noncausal_ragged(cuda, G, KV, hd, S, T, dtype):
    """Non-causal flash at the cross and encoder shapes: every key row
    attended, ragged S and T, one count per call."""
    g = torch.Generator().manual_seed(S + T + hd)
    q, k, v = (_randn(g, 1, S, G * KV, hd), _randn(g, 1, T, KV, hd),
               _randn(g, 1, T, KV, hd))
    q, k, v = (t.to(dtype).cuda() for t in (q, k, v))
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=False)
    assert torch.isfinite(got).all()
    atol = 1e-4 if dtype == torch.float32 else ATOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=RTOL[dtype],
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,B,T,kv_len", [
    (8, 2, 4100, 4100),         # vision's cross decode: all media rows
    (8, 3, 4099, 4099),         # ragged T, no 64-row tile boundary
    (6, 2, 2048, 2001),         # internlm2's grouping, sync decode
])
def test_decode_at_the_catalog_groupings(cuda, G, B, T, kv_len, dtype):
    g = torch.Generator().manual_seed(G * T + B)
    KV, hd = 2, 128
    q = _randn(g, B, G * KV, hd)
    k, v = _randn(g, B, T, KV, hd), _randn(g, B, T, KV, hd)
    k[:, kv_len:], v[:, kv_len:] = float("nan"), float("inf")   # never read
    q, k, v = (t.to(dtype).cuda() for t in (q, k, v))
    before = launch_counts()["decode_attention"]
    got = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == before + 1
    want = decode_attention_plain(q, k, v, kv_len)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=RTOL[dtype],
                               atol=ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,kv_len", [(700, None), (300, 257)])
def test_flash_at_g6(cuda, S, kv_len, dtype):
    """internlm2's grouping, 6 query heads a KV head: the causal
    prefill, one count per call."""
    g = torch.Generator().manual_seed(S)
    KV, hd = 2, 128
    q, k, v = (_randn(g, 1, S, 6 * KV, hd), _randn(g, 1, S, KV, hd),
               _randn(g, 1, S, KV, hd))
    q, k, v = (t.to(dtype).cuda() for t in (q, k, v))
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=True, kv_len=kv_len)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    atol = 1e-4 if dtype == torch.float32 else ATOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=RTOL[dtype],
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,K,N", [(4, 2048, 1408), (4, 1408, 2048),
                                   (236, 2048, 1408), (236, 1408, 2048)])
def test_moe_gmm_at_64_experts(cuda, C, K, N, dtype):
    """deepseek-v2-lite's expert products, 64 experts: a decode step's
    capacity (4) and a 2000-token prefill's (236), gate/up and down."""
    g = torch.Generator().manual_seed(C + K)
    x, w = _moe_operands(g, 64, C, K, N, dtype)
    before = launch_counts()["moe_gmm"]
    got = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert launch_counts()["moe_gmm"] == before + 1
    atol = 2e-3 if dtype == torch.float32 else ATOL[dtype]
    rtol = 1e-5 if dtype == torch.float32 else RTOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               moe_gmm_plain(x, w).float().cpu().numpy(),
                               rtol=rtol, atol=atol)


# -- training (the plain path on the card) ----------------------------------

def _train_state(cfg, device):
    from repro_torch.train import init_opt_state
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = _to(params, device)
    return params, init_opt_state(params)


def _to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _train_batch(cfg):
    from repro_torch.data import SyntheticLM
    return {k: torch.from_numpy(v) for k, v in
            SyntheticLM(cfg.vocab_size, batch=4, seq_len=64, seed=0)(0)
            .items()}


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One float32 step of reduced qwen2-7b (2 microbatches) on the card
    and on the CPU from the same weights and batch: metrics to rtol 1e-4,
    parameters to the train step's tolerance (rtol 5e-3, atol 2e-3)."""
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              dtype="float32", use_kernels=False,
                              microbatches=2)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1))
    batch = _train_batch(cfg)
    want = step(*_train_state(cfg, "cpu"), batch)
    got = step(*_train_state(cfg, cuda), _to(batch, cuda))
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                   rtol=1e-4, atol=1e-12, err_msg=k)
    for a, b in zip(leaves(got[0]), leaves(want[0])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        torch.testing.assert_close(a.cpu(), b, rtol=5e-3, atol=2e-3)


@pytest.mark.cuda
def test_bf16_gradient_on_the_card_matches_the_cpu(cuda):
    """The bf16 gradient of reduced qwen2-7b on the card (its f32-output
    products through ``layers._MmF32``) lies no further from the CPU's
    float32 gradient of the same weights than 1.5x the CPU's own bf16
    gradient does (the CPU upcasts bf16 products; the card rounds their
    gradients' operands to bf16)."""
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              use_kernels=False)
    params, _ = _train_state(cfg, "cpu")
    batch = _train_batch(cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _, m32, g32 = loss_and_grads(cfg32, tree_map(lambda t: t.float(), params),
                                 batch)
    _, m_cpu, g_cpu = loss_and_grads(cfg, params, batch)
    _, m_card, g_card = loss_and_grads(cfg, _to(params, cuda),
                                       _to(batch, cuda))

    def dist(g):
        num = sum(float((a.cpu().float() - b).square().sum())
                  for a, b in zip(leaves(g), leaves(g32)))
        return math.sqrt(num / sum(float(b.square().sum())
                                   for b in leaves(g32)))
    yardstick, card = dist(g_cpu), dist(g_card)
    print(f"bf16 gradient vs float32: card {card:.5f}, CPU {yardstick:.5f}")
    assert all(g.device.type == "cuda" and g.dtype == torch.bfloat16
               for g in leaves(g_card))
    assert 0.0 < card <= 1.5 * yardstick
    np.testing.assert_allclose(float(m_card["ce"]), float(m32["ce"]),
                               rtol=1e-2)


@pytest.mark.cuda
def test_mm_f32_output_backward_on_the_card(cuda):
    """The bf16 product with an f32 output differentiates: its gradients
    are the products of the output gradient, rounded to bf16 once, with
    the other operand, each rounded once (one bf16 ulp)."""
    from repro_torch.models.layers import mm
    g = torch.Generator().manual_seed(1)
    a = torch.randn((3, 64, 128), generator=g).to(torch.bfloat16).to(cuda)
    b = torch.randn((128, 96), generator=g).to(torch.bfloat16).to(cuda)
    a.requires_grad_()
    b.requires_grad_()
    y = mm(a, b)
    assert y.dtype == torch.float32 and y.shape == (3, 64, 96)
    dy = torch.randn(y.shape, generator=g).to(cuda)
    ga, gb = torch.autograd.grad(y, (a, b), dy)
    d16 = dy.to(torch.bfloat16).float()
    want_a = (d16 @ b.float().t()).to(torch.bfloat16)
    want_b = (a.detach().float().reshape(-1, 128).t()
              @ d16.reshape(-1, 96)).to(torch.bfloat16)
    for got, want in ((ga, want_a), (gb, want_b)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-2)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    """Every wrapper raises before launching when a CUDA operand requires
    grad under grad mode."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype).to(cuda)

    lens = torch.tensor([16], dtype=torch.int32, device=cuda)
    table = torch.tensor([[1, 0]], dtype=torch.int32, device=cuda)
    calls = {
        "flash_attention": (flash_attention, (r(1, 16, 4, 64),
                                              r(1, 16, 2, 64),
                                              r(1, 16, 2, 64))),
        "decode_attention": (decode_attention, (r(1, 4, 64),
                                                r(1, 16, 2, 64),
                                                r(1, 16, 2, 64), 16)),
        "paged_decode_attention": (paged_decode_attention,
                                   (r(1, 4, 64), r(2, 16, 2, 64),
                                    r(2, 16, 2, 64), table, lens)),
        "moe_gmm": (moe_gmm, (r(2, 16, 64), r(2, 64, 64))),
        "mamba2_ssd": (mamba2_ssd, (r(1, 64, 2, 64),
                                    r(1, 64, 2, dtype=torch.float32).abs(),
                                    -r(2, dtype=torch.float32).abs(),
                                    r(1, 64, 1, 64), r(1, 64, 1, 64))),
        "mfma_gemm": (mfma_gemm, (r(64, 64), r(64, 64),
                                  r(64, 64, dtype=torch.float32))),
        "listing1": (LISTING1.listing1, (r(16, 16), r(16, 8),
                                         r(16, 8, dtype=torch.float32), 2)),
    }
    reset_launch_counts()
    for name, (fn, args) in calls.items():
        x = args[0].detach().requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            fn(x, *args[1:])
    assert not any(launch_counts().values())
    for name, (fn, args) in calls.items():
        with torch.no_grad():
            fn(args[0].detach().requires_grad_(), *args[1:])
    torch.cuda.synchronize()
    assert all(launch_counts()[name] == 1 for name in calls)


LISTING1 = importlib.import_module("repro_torch.kernels.listing1")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(LISTING1.KINDS))
def test_listing1_chains_exactly_and_takes_longer_with_n(cuda, kind):
    """Each variant at N = 2..5 (and the N = 0 overhead stream): D equals
    the plain version exactly in every launch, and the median T_total
    rises strictly with N."""
    medians = {}
    for n in (0, 2, 3, 4, 5):
        med, totals, ds, want = LISTING1.stream_cycles(kind, n, launches=20,
                                                       seed=n)
        assert ds.dtype == want.dtype and ds.shape[1:] == want.shape
        assert bool((ds == want).all()), (kind, n)
        assert len(totals) == 20 and min(totals) > 0
        medians[n] = med
    ns = sorted(medians)
    assert all(medians[a] < medians[b] for a, b in zip(ns, ns[1:])), medians


@pytest.mark.cuda
def test_listing1_wrapper_on_the_card(cuda):
    """One launch through the public wrapper: D and two stamps on the
    card, counted; a CUDA operand never takes the plain version."""
    a, b, c = LISTING1.operands("bf16", seed=3)
    reset_launch_counts()
    d, stamps = LISTING1.listing1(a, b, c, 4)
    torch.cuda.synchronize()
    assert d.device.type == "cuda" and stamps.shape == (2,)
    assert torch.equal(d, LISTING1.listing1_plain(a, b, c, 4))
    assert LISTING1.t_total(stamps.cpu()) > 0
    assert launch_counts()["listing1"] == 1


#: tests/test_fleet.py's four mixes: (prompt length, n_steps, arrival)
FLEET_TRACES = {
    "decode_heavy": [(6, 24, 0), (9, 30, 0), (7, 18, 1)],
    "prefill_heavy": [(130, 3, 0), (120, 2, 0), (96, 2, 1)],
    "gapped": [(8, 6, 0), (10, 5, 14), (12, 4, 30)],
    "mixed": [(64, 10, 0), (9, 20, 0), (100, 4, 2), (12, 12, 3)],
}
#: tests/test_fleet.py's engine settings
FLEET_ENGINE = dict(max_len=160, max_batch=2, page=128, prefill_chunk=32,
                    prefix_cache=False)


def _fleet_engine():
    cfg = get_config("qwen2-7b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    return cfg, PagedServeEngine(cfg, params, **FLEET_ENGINE)


def _fleet_trace(cfg, specs, seed=7):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, (s,))
                    .astype(np.int32), n_steps=n, arrival=a)
            for s, n, a in specs]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FLEET_TRACES))
def test_fleet_replica_tick_exact_on_the_card(cuda, name):
    """The fleet replica against the paged engine on the kernel path
    (reduced qwen2-7b at tests/test_fleet.py's settings): every counter
    equal, and the paged kernel launched once per layer per decode
    step."""
    from repro_torch.fleet import simulate_trace
    cfg, eng = _fleet_engine()
    reset_launch_counts()
    _, stats = eng.run(_fleet_trace(cfg, FLEET_TRACES[name]))
    assert launch_counts()["paged_decode_attention"] == \
        cfg.n_layers * stats.decode_steps
    sim = simulate_trace(_fleet_trace(cfg, FLEET_TRACES[name]),
                         max_len=eng.max_len, max_batch=eng.max_batch,
                         page=eng.page, n_blocks=eng.cache.n_blocks,
                         prefill_chunk=eng.prefill_chunk)
    for field in ("requests", "tokens", "ticks", "decode_steps",
                  "prefill_chunks", "completed", "shed", "timeouts",
                  "cancelled", "preemptions", "stalled_ticks"):
        assert getattr(sim, field) == stats[field], field
    assert abs(sim.occupancy_max - stats.occupancy_max) <= 1e-12


@pytest.mark.cuda
def test_fleet_fitted_costs_predict_heldout_trace_on_the_card(cuda):
    """tests/test_fleet.py's calibration band on the card's kernel path:
    tick costs fitted on the decode-heavy, prefill-heavy and gapped
    mixes predict the held-out mixed trace's per-token latency within
    [0.5, 2.0]x.  (On the CPU under the suite's workers the walls share
    the cores and the band is unsteady, so it is held here.)"""
    import time
    from repro_torch.fleet import fit_tick_costs
    cfg, eng = _fleet_engine()
    eng.run(_fleet_trace(cfg, [(8, 3, 0)]))          # warm-up

    def timed(specs, seed):
        trace = _fleet_trace(cfg, specs, seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats = eng.run(trace)
        torch.cuda.synchronize()
        return stats, time.perf_counter() - t0

    obs = [timed(FLEET_TRACES[k], seed)
           for seed, k in enumerate(("decode_heavy", "prefill_heavy",
                                     "gapped"))]
    costs = fit_tick_costs(obs)
    held_stats, held_wall = timed(FLEET_TRACES["mixed"], seed=99)
    predicted = costs.token_latency_s(held_stats)
    measured = held_wall / held_stats["tokens"]
    assert 0.5 * measured <= predicted <= 2.0 * measured, \
        f"predicted {predicted * 1e3:.3f} ms/tok vs measured " \
        f"{measured * 1e3:.3f} ms/tok ({costs})"


# -- the kernels on a mesh's local blocks --------------------------------
#
# The four kernels with a logical-axis contract, each launched on every
# local block a (2, 2) ("data", "model") mesh gives its ranks
# (``kernels.sharded.on_local_blocks``: batch on data, heads or experts
# on model), on one card and without a process group; the blocks put back
# together are held to the unsharded launch under the bf16 rule.  On the
# card's one-rank mesh every placement is Replicate(), so only this shows
# a kernel at a shard's local shapes (heads and batch halved, and for
# decode another split of the cache: ``kernel_split_rows`` reads B * KV).

MESH_2X2 = {"data": 2, "model": 2}


def _held_on_blocks(kernel, fn, operands):
    from repro_torch.kernels.sharded import on_local_blocks
    whole = fn(*operands)
    before = launch_counts()[kernel]
    got, local = on_local_blocks(kernel, fn, operands, MESH_2X2, whole)
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == before + 4      # one a rank
    assert len(local) == 1                            # even blocks
    pairs = zip(got, whole) if isinstance(got, tuple) else [(got, whole)]
    for g, w in pairs:
        assert torch.isfinite(g).all()
        f32 = g.dtype == torch.float32
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   rtol=1e-4 if f32 else 2.0 ** -7,
                                   atol=1e-3 if f32 else 1e-2)
    return local.pop()


@pytest.mark.cuda
def test_flash_kernel_on_mesh_blocks(cuda):
    g = torch.Generator().manual_seed(30)
    q = _randn(g, 4, 256, 8, 64).to(torch.bfloat16).cuda()
    k, v = (_randn(g, 4, 256, 4, 64).to(torch.bfloat16).cuda()
            for _ in range(2))
    local = _held_on_blocks("flash_attention",
                            lambda *t: flash_attention(*t, causal=True),
                            (q, k, v))
    assert local == ((2, 256, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("per_request", [False, True])
def test_decode_kernel_on_mesh_blocks(cuda, per_request):
    g = torch.Generator().manual_seed(31)
    B, H, KV, hd, T = 4, 8, 4, 128, 3072
    q = _randn(g, B, H, hd).to(torch.bfloat16).cuda()
    k, v = (_randn(g, B, T, KV, hd).to(torch.bfloat16).cuda()
            for _ in range(2))
    # the halved B * KV takes another split of the cache
    assert kernel_split_rows(T, B * KV) != kernel_split_rows(T, B * KV // 4)
    if per_request:
        lens = torch.tensor([3072, 1, 2000, 129], dtype=torch.int32).cuda()
        local = _held_on_blocks("decode_attention", decode_attention,
                                (q, k, v, lens))
    else:
        local = _held_on_blocks("decode_attention",
                                lambda *t: decode_attention(*t, 2900),
                                (q, k, v))
    assert local[:3] == ((2, 4, 128), (2, T, 2, 128), (2, T, 2, 128))


@pytest.mark.cuda
def test_moe_gmm_kernel_on_mesh_blocks(cuda):
    g = torch.Generator().manual_seed(32)
    x, w = _moe_operands(g, 8, 32, 256, 128, torch.bfloat16)
    local = _held_on_blocks("moe_gmm", moe_gmm, (x, w))
    assert local == ((4, 32, 256), (4, 256, 128))     # experts on model


@pytest.mark.cuda
def test_mamba2_ssd_kernel_on_mesh_blocks(cuda):
    g = torch.Generator().manual_seed(33)
    B, S, nh, hd, G, ds = 2, 256, 8, 64, 1, 128
    x = (_randn(g, B, S, nh, hd) * 0.5).to(torch.bfloat16).cuda()
    dt = (_randn(g, B, S, nh).abs() * 0.8 + 0.05).cuda()
    A = (-_randn(g, nh).abs() - 0.1).cuda()
    Bm, Cm = ((_randn(g, B, S, G, ds) * 0.5).to(torch.bfloat16).cuda()
              for _ in range(2))
    local = _held_on_blocks("mamba2_ssd", mamba2_ssd, (x, dt, A, Bm, Cm))
    # heads on model, the one B/C group broadcast to every rank
    assert local == ((1, S, 4, hd), (1, S, 4), (4,), (1, S, 1, ds),
                     (1, S, 1, ds))
