"""The port's tile planner: on the reference's five devices ``plan_for``
equals the reference's for the six kernels in f32 and bf16, padded or
not, with overrides, errors included; on the H100 each plan is the tile
the CUDA kernel runs, read from the wrapper modules' constants, which
are held here to the ``.cu`` sources, and a shape the wrapper refuses
raises the wrapper's own ``ValueError``."""

import dataclasses
import importlib
import re
from pathlib import Path

import pytest
import torch

from _torch_perf import REF_DEVICES, plain
from _torch_timing import outcome
from repro.arch import get_device as ref_get_device
from repro.kernels import plan as ref_plan
from repro_torch.arch import get_device
from repro_torch.kernels import plan

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"

SHAPES = {
    "mfma_gemm": [dict(M=256, N=256, K=256), dict(M=100, N=300, K=70),
                  dict(M=2048, N=18944, K=3584), dict(M=8, N=18944, K=3584),
                  dict(M=64, N=128, K=1000)],
    "moe_gmm": [dict(E=8, C=160, K=4096, N=1536),
                dict(E=4, C=32, K=128, N=256), dict(E=2, C=5, K=72, N=88)],
    "flash_attention": [dict(B=1, S=2048, T=2048, H=28, KV=4, hd=128),
                        dict(B=2, S=64, T=64, H=4, KV=2, hd=32),
                        dict(B=1, S=100, T=100, H=4, KV=2, hd=96)],
    "decode_attention": [dict(B=4, T=2048, H=28, KV=4, hd=128),
                         dict(B=2, T=100, H=4, KV=2, hd=32)],
    "paged_decode_attention": [dict(B=4, T=2048, H=28, KV=4, hd=128,
                                    page=64),
                               dict(B=2, T=256, H=4, KV=2, hd=32, page=128),
                               dict(B=2, T=300, H=4, KV=2, hd=32, page=100)],
    "mamba2_ssd": [dict(B=1, S=2048, nh=32, hd=64, ds=128),
                   dict(B=2, S=52, nh=4, hd=16, ds=16),
                   dict(B=1, S=2000, nh=128, hd=64, ds=16)],
}
OVERRIDES = {"mfma_gemm": [{}, {"block_m": 128}, {"block_m": 100},
                           {"block_x": 8}],
             "moe_gmm": [{}, {"block_n": 128}],
             "flash_attention": [{}, {"block_kv": 128}],
             "decode_attention": [{}, {"block_kv": 256}],
             "paged_decode_attention": [{}],
             "mamba2_ssd": [{}, {"chunk": 64}, {"chunk": 60}]}


def _wrapper(name):
    return importlib.import_module(f"repro_torch.kernels.{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "f32", "bf16"])
@pytest.mark.parametrize("device", REF_DEVICES)
@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_plan_for_equals_reference(kernel, device, dtype):
    """Every shape x pad x override: the same TilePlan, or the same
    exception class and message."""
    for shapes in SHAPES[kernel]:
        for pad in (False, True):
            for ov in OVERRIDES[kernel]:
                got = outcome(plan.plan_for, kernel, shapes, dtype=dtype,
                              device=device, pad=pad, **ov)
                want = outcome(ref_plan.plan_for, kernel, shapes,
                               dtype=dtype, device=device, pad=pad, **ov)
                assert plain(got) == plain(want), (shapes, pad, ov)


def test_planner_errors_and_contracts_equal_reference():
    """Unknown dtypes, kernels, budget overflows; ``validate_tiling``;
    the quanta; the catalog's rows."""
    for dtype in ("c64", "int4", "fp8", "bool"):
        got = outcome(plan.plan_for, "mfma_gemm", dict(M=256, N=256, K=256),
                      dtype=dtype, device="mi300")
        assert plain(got) == plain(outcome(
            ref_plan.plan_for, "mfma_gemm", dict(M=256, N=256, K=256),
            dtype=dtype, device="mi300"))
    assert outcome(plan.plan_for, "nope", {}) == \
        outcome(ref_plan.plan_for, "nope", {})
    with pytest.raises(plan.UnknownDtypeError):
        plan.plan_for("mfma_gemm", dict(M=128, N=128, K=128), dtype="c64")
    tiny = dict(vmem_bytes=64 << 10)
    got = outcome(plan.plan_for, "mfma_gemm", dict(M=512, N=512, K=512),
                  device=get_device("mi200").derive("tiny", **tiny))
    assert got[:2] == ("raises", "ValueError")
    assert got == outcome(ref_plan.plan_for, "mfma_gemm",
                          dict(M=512, N=512, K=512),
                          device=ref_get_device("mi200").derive("tiny",
                                                                **tiny))
    for dims, kw in (({"M": (256, 128)}, {}), ({"M": (256, 100)}, {}),
                     ({"K": (70, 70)}, {}), ({"M": (64, 64)}, {}),
                     ({"S": (52, 13)}, {"quantum": 8}),
                     ({"S": (48, 16)}, {"quantum": 8}),
                     ({"N": (300, 0)}, {})):
        assert outcome(plan.validate_tiling, "k", dims, **kw) == \
            outcome(ref_plan.validate_tiling, "k", dims, **kw)
    for device in REF_DEVICES:
        assert plan.tile_align(get_device(device)) == \
            ref_plan.tile_align(ref_get_device(device))
        assert plan.vmem_budget(get_device(device)) == \
            ref_plan.vmem_budget(ref_get_device(device))
    assert plan.list_kernels() == ref_plan.list_kernels()
    for name in plan.list_kernels():
        got, want = plan.get_kernel(name), ref_plan.get_kernel(name)
        assert (got.block_names, got.logical) == \
            (want.block_names, want.logical)
        mod = _wrapper("decode_attention" if "decode" in name else name)
        assert got.op_fn is getattr(mod, name)
        assert got.ref_fn is getattr(mod, f"{name}_plain")


def _cu(name):
    """``constexpr int kX = N;`` of a CUDA source, as {kX: N}."""
    text = (CSRC / name).read_text()
    return text, {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|uint32_t) (k\w+) = (\d+);", text)}


def test_wrapper_constants_are_the_cuda_sources_tiles():
    g, f = _wrapper("mfma_gemm"), _wrapper("flash_attention")
    d, m, s = (_wrapper("decode_attention"), _wrapper("moe_gmm"),
               _wrapper("mamba2_ssd"))
    text, k = _cu("mfma_gemm.cu")
    assert (k["kWM"], k["kWN"], k["kWK"], k["kWStages"]) == \
        (g.WGMMA_ROWS, g.WGMMA_COLUMNS, g.BLOCK_K, g.STAGES)
    assert (k["kDN"], k["kDK"], k["kDStages"]) == \
        (g.DECODE_COLUMNS, g.BLOCK_K, g.STAGES)
    assert (k["kBM"], k["kBN"], k["kBK"]) == (g.TILE, g.TILE, g.TILE_K)
    assert f"K % {g.VECTOR} == 0 && N % {g.VECTOR} == 0" in text
    assert [int(r) for r in re.findall(r"if \(M <= (\d+)\)", text)] == \
        list(g.DECODE_ROW_TILES) and g.DECODE_ROW_TILES[-1] == g.DECODE_ROWS
    assert "64 x 256 x 16" in text and g.WGMMA_M == 64
    text, k = _cu("flash_attention.cu")
    assert (k["kBQ"], k["kBKV"]) == (f.QUERY_ROWS, f.TILE)
    assert f"(kBQ + 2 * {f.STAGES} * kBKV)" in text
    text, k = _cu("decode_split.cuh")
    assert k["kTile"] == d.TILE and f"2 * {d.STAGES} * kTile" in text
    text, k = _cu("moe_gmm.cu")
    assert (k["kRN"], k["kRK"], k["kStages"]) == \
        (m.RING_COLUMNS, m.RING_K, m.RING_STAGES)
    assert (k["kBM"], k["kBN"], k["kBK"]) == (m.TILE, m.TILE, m.TILE_K)
    assert tuple(int(r) for r in re.findall(
        r"launch_ring<T, (\d+)>\(x", text)) == m.RING_ROWS
    assert f"int V = 16 / sizeof(T)" in text and m.VECTOR == 16 // 2
    _, k = _cu("mamba2_ssd.cu")
    assert k["kQ"] == s.CHUNK


def _h100(kernel, dtype="bf16", **shapes):
    return plan.plan_for(kernel, shapes, dtype=dtype, device="h100")


def _blocks(p):
    return tuple(p.blocks.values())


def test_h100_plans_are_the_kernels_tiles():
    g, m = _wrapper("mfma_gemm"), _wrapper("moe_gmm")
    d = _wrapper("decode_attention")
    wgmma = (g.WGMMA_ROWS, g.WGMMA_COLUMNS, g.BLOCK_K)
    assert _blocks(_h100("mfma_gemm", M=2048, N=18944, K=3584)) == wgmma
    assert _blocks(_h100("mfma_gemm", M=65, N=8, K=8)) == wgmma
    for M, rows in ((1, 16), (8, 16), (17, 32), (40, 64), (64, 64)):
        assert _blocks(_h100("mfma_gemm", M=M, N=18944, K=3584)) == \
            (rows, g.DECODE_COLUMNS, g.BLOCK_K)
    fallback = (g.TILE, g.TILE, g.TILE_K)
    assert _blocks(_h100("mfma_gemm", "f32", M=2048, N=256, K=256)) == \
        fallback
    assert _blocks(_h100("mfma_gemm", M=2048, N=256, K=70)) == fallback
    for C, rows in ((5, 16), (32, 32), (33, 64), (160, 128)):
        assert _blocks(_h100("moe_gmm", E=8, C=C, K=4096, N=1536)) == \
            (rows, m.RING_COLUMNS, m.RING_K)
    assert _blocks(_h100("moe_gmm", "f32", E=8, C=32, K=64, N=64)) == \
        (m.TILE, m.TILE, m.TILE_K)
    p = _h100("flash_attention", B=1, S=2048, T=2048, H=28, KV=4, hd=128)
    assert p.blocks == {"block_q": 64, "block_kv": 64}
    assert p.grid == (28, 32, 32)
    for kernel, extra in (("decode_attention", {}),
                          ("paged_decode_attention", {"page": 64})):
        p = _h100(kernel, B=4, T=2048, H=28, KV=4, hd=128, **extra)
        assert p.blocks == {"block_kv": d.TILE,
                            "split_rows": d.kernel_split_rows(2048, 16)}
    assert _h100("mamba2_ssd", B=1, S=2000, nh=4, hd=64, ds=16
                 ).blocks == {"chunk": _wrapper("mamba2_ssd").CHUNK}
    p = _h100("mfma_gemm", M=100, N=300, K=70)
    assert (p.padded, dict(p.dims), p.grid) == \
        (False, {"M": 100, "N": 300, "K": 70}, (2, 5, 3))
    assert plain(plan.plan_for("mfma_gemm", dict(M=100, N=300, K=70),
                               dtype="bf16", device="h100",
                               pad=True)) == plain(p)
    assert (p.align, p.vmem_budget) == (64, 232448)
    assert plan.tile_align(get_device("h100")) == 64
    assert plan.vmem_budget(get_device("h100")) == 232448


def _raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise")


def test_h100_refuses_what_the_wrappers_refuse():
    """The same message as the wrapper's own check on CPU tensors."""
    kernels = importlib.import_module("repro_torch.kernels")
    q = torch.zeros(1, 8, 4, 96)
    assert _raised(_h100, "flash_attention", B=1, S=8, T=8, H=4, KV=2,
                   hd=96) == _raised(kernels.flash_attention, q,
                                     q[:, :, :2], q[:, :, :2])
    k = torch.zeros(1, 16, 2, 48)
    assert _raised(_h100, "decode_attention", B=1, T=16, H=4, KV=2,
                   hd=48) == _raised(kernels.decode_attention,
                                     torch.zeros(1, 4, 48), k, k, 16)
    pool = torch.zeros(3, 24, 2, 32)
    assert _raised(_h100, "paged_decode_attention", B=1, T=48, H=4, KV=2,
                   hd=32, page=24) == _raised(
        kernels.paged_decode_attention, torch.zeros(1, 4, 32), pool, pool,
        torch.zeros(1, 2, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32))
    x = torch.zeros(1, 8, 2, 16)
    bc = torch.zeros(1, 8, 1, 24)
    assert _raised(_h100, "mamba2_ssd", B=1, S=8, nh=2, hd=16, ds=24) == \
        _raised(kernels.mamba2_ssd, x, torch.zeros(1, 8, 2), torch.zeros(2),
                bc, bc)


def test_h100_dtypes_overrides_and_budget():
    with pytest.raises(plan.UnknownDtypeError, match="f32, bf16 or f16"):
        _h100("mfma_gemm", "s8", M=128, N=128, K=128)
    with pytest.raises(plan.UnknownDtypeError, match="unknown dtype"):
        _h100("mfma_gemm", "c64", M=128, N=128, K=128)
    assert _blocks(_h100("mfma_gemm", torch.bfloat16, M=2048, N=256,
                         K=256)) == (128, 256, 64)
    assert plan.plan_for("mfma_gemm", dict(M=2048, N=256, K=256),
                         device="h100", block_m=128).blocks["block_m"] == 128
    with pytest.raises(ValueError, match="fix their own tiles"):
        plan.plan_for("mfma_gemm", dict(M=2048, N=256, K=256),
                      device="h100", block_m=256)
    small = get_device("h100").derive("h100_small", vmem_bytes=96 << 10)
    with pytest.raises(ValueError, match="shared-memory budget"):
        plan.plan_for("mfma_gemm", dict(M=2048, N=256, K=256), device=small)
    assert plan.plan_for("mfma_gemm", dict(M=8, N=256, K=256),
                         device=small).vmem_bytes <= 96 << 10
    entry = dataclasses.replace(plan.get_kernel("mfma_gemm"),
                                name="no_cuda_twin", hopper=None)
    plan.register_kernel(entry)
    try:
        with pytest.raises(ValueError, match="no CUDA kernel"):
            plan.plan_for("no_cuda_twin", dict(M=8, N=8, K=8),
                          device="h100")
    finally:
        plan._CATALOG.pop("no_cuda_twin")
