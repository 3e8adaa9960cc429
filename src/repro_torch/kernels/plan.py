"""Spec-driven tile planning: ``TilePlan`` / ``plan_for`` / the catalog
(twin of ``repro.kernels.plan``).

The planner serves the perf layer only (``repro_torch.perf.engines``:
``plan_for_dot`` and ``Report.plan``): the port's CUDA kernels fix their
own tiles and never ask it.  On the reference's five devices it plans
exactly as the reference does:

* the **alignment quantum** comes from the compute topology —
  ``mxu_dim`` (the 128x128 systolic array) on TPUs; on MFMA cycle-table
  GPUs the same 128 width, which an MCE assembles as an 8x8 grid of
  16x16 micro-tiles, so one plan serves both device families;
* the **working-set budget** is ``DeviceSpec.vmem_bytes`` (VMEM per TPU
  core, an L2 staging slice on GPUs), with half reserved for the
  double-buffered prefetch pipeline;
* tiles are chosen as the largest aligned divisors of the problem dims
  under per-kernel caps, then shrunk greedily until the working set fits.

On the H100 (``family == "nvidia-hopper"``) the quanta are Hopper's: the
alignment is the ``wgmma`` M = 64 tile and the budget is one block's
shared memory (all of ``vmem_bytes``: the kernels' rings are part of the
footprint).  Nothing is searched there: each kernel's plan is the tile
its CUDA kernel runs for those shapes and that dtype, read from the
wrapper modules' constants (``repro_torch.kernels.mfma_gemm``'s
``WGMMA_ROWS``, ``BLOCK_K``, ``DECODE_ROWS``, ...), and a shape the
kernel's wrapper refuses raises its ``ValueError`` here too.  The
kernels mask ragged edges, so no H100 plan pads (``padded`` is False and
``dims`` are the problem's).  ``vmem_bytes`` is the operand tiles one
block stages in shared memory (ring stages x the A and B slices, rows
unpadded).

:func:`plan_for` is the entry point; :class:`KernelEntry` catalog rows
make kernels enumerable by name (the port's wrapper + its plain
version + planner).  :func:`validate_tiling` is the reference's shared
alignment contract — a sub-128 or non-dividing block raises
``ValueError`` naming the offending dim instead of silently clamping.

This module imports no torch itself; the H100 planners import the
wrapper modules (which do) when they are called.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import (Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

from repro_torch.arch.registry import get_device
from repro_torch.arch.spec import DeviceSpec

__all__ = [
    "TilePlan",
    "KernelEntry",
    "UnknownKernelError",
    "UnknownDtypeError",
    "plan_for",
    "register_kernel",
    "get_kernel",
    "list_kernels",
    "tile_align",
    "vmem_budget",
    "validate_tiling",
    "DEFAULT_PLAN_DEVICE",
    "SUBLANE",
    "HOPPER",
]

#: Planning device when the caller names none (CPU containers have no
#: backend to introspect; the base TPU is the canonical Pallas target).
DEFAULT_PLAN_DEVICE = "tpu_v5e"

#: The device family whose kernels are the port's CUDA kernels (the
#: ``h100`` spec's): planned by the tiles those kernels run.
HOPPER = "nvidia-hopper"

#: Fallback working-set budget for specs predating ``vmem_bytes``.
_DEFAULT_VMEM_BYTES = 16 << 20

#: Quantum for sequence-chunked (non-GEMM-tiled) dims: the VPU's 8-row
#: sublane granularity, not the MXU width.
SUBLANE = 8

#: numpy/torch-style spellings -> the canonical HLO names of
#: ``repro_torch.perf.hlo_ir.BYTES_PER_ELEM`` (the ONE byte table).
_DTYPE_ALIASES = {
    "float64": "f64", "fp64": "f64",
    "float32": "f32", "fp32": "f32",
    "float16": "f16", "fp16": "f16",
    "bfloat16": "bf16",
    "int64": "s64", "uint64": "u64",
    "int32": "s32", "i32": "s32", "uint32": "u32",
    "int16": "s16", "uint16": "u16",
    "int8": "s8", "i8": "s8", "uint8": "u8",
    "int4": "s4", "uint4": "u4",
    "float8_e4m3fn": "f8e4m3fn", "fp8": "f8e4m3fn",
    "float8_e5m2": "f8e5m2",
    "bool": "pred",
}


def _itemsize(dtype) -> int:
    """Bytes per element for a numpy/torch dtype object or an HLO name."""
    # lazy: hlo_ir is stdlib-only, but importing it at module scope would
    # pull the whole perf package under this deliberately light module
    from repro_torch.perf.hlo_ir import BYTES_PER_ELEM
    name = str(dtype).lower()
    size = BYTES_PER_ELEM.get(_DTYPE_ALIASES.get(name, name))
    if size is not None:
        return size
    itemsize = getattr(dtype, "itemsize", None) or getattr(
        getattr(dtype, "dtype", None), "itemsize", None)
    if itemsize:
        return int(itemsize)
    raise UnknownDtypeError(
        f"unknown dtype {dtype!r}: cannot size tiles "
        f"(known: {sorted(BYTES_PER_ELEM)} and aliases)")


class UnknownKernelError(KeyError):
    """Raised for a kernel name not in the catalog."""


class UnknownDtypeError(ValueError):
    """Raised when a dtype cannot be sized for tile planning.

    Distinct from the plain ``ValueError`` contract violations
    (misalignment, budget overflow) so callers with a fallback dtype —
    ``repro_torch.perf.engines.plan_for_dot`` — can retry on exactly this
    failure without masking real planning errors."""


def tile_align(spec: DeviceSpec) -> int:
    """The matrix-unit alignment quantum for GEMM-tiled dims on ``spec``:
    on Hopper the rows of one ``wgmma`` (64)."""
    if spec.family == HOPPER:
        return _wrapper("mfma_gemm").WGMMA_M
    return spec.mxu_dim if spec.mxu_count else 128


def vmem_budget(spec: DeviceSpec) -> int:
    """Plannable working-set bytes: half the fast-memory budget (the
    other half is the double-buffered prefetch pipeline).  On Hopper one
    block's shared memory, whole: the kernels' rings are counted in
    each plan's footprint."""
    if spec.family == HOPPER:
        return spec.vmem_bytes or _DEFAULT_VMEM_BYTES
    return (spec.vmem_bytes or _DEFAULT_VMEM_BYTES) // 2


# ---------------------------------------------------------------------------
# The alignment contract (shared with the kernels themselves)
# ---------------------------------------------------------------------------

def validate_tiling(kernel: str,
                    dims: Mapping[str, Tuple[int, int]], *,
                    align: int = 128,
                    depth_dims: Sequence[str] = ("K",),
                    block_names: Optional[Mapping[str, str]] = None,
                    quantum: Optional[int] = None) -> None:
    """Enforce the matrix-unit tiling contract.

    ``dims`` maps dim name -> ``(dim, block)``; ``block_names`` maps dim
    name -> the kernel's keyword for it (default ``block_<dim>``), used
    in error messages.  Every block must divide its dim and be a multiple
    of ``align``; dims listed in ``depth_dims`` (the contraction) may
    alternatively use one full-depth step (``block == dim``), which
    streams the whole reduction in a single grid iteration and so has no
    unaligned tile boundary.  ``quantum`` overrides ``align`` for dims
    that are sublane- rather than MXU-quantised (the SSD chunk).

    Raises ``ValueError`` naming the offending dim — the silent
    ``min(block, dim)`` clamp this replaces let e.g. M=64 run with a
    64-wide, non-MXU tile.
    """
    q = quantum or align
    names = block_names or {}
    for dim_name, (dim, block) in dims.items():
        block_name = names.get(dim_name, f"block_{dim_name.lower()}")
        if block < 1:
            raise ValueError(f"{kernel}: {block_name}={block} must be >= 1")
        if dim % block:
            raise ValueError(
                f"{kernel}: {dim_name}={dim} is not divisible by "
                f"{block_name}={block}; pad {dim_name} or pick a divisor "
                "(the XLA reference path handles ragged shapes)")
        if block % q and not (dim_name in depth_dims and block == dim):
            depth_hint = (" (a single full-depth step block == "
                          f"{dim_name} is also legal)"
                          if dim_name in depth_dims else "")
            raise ValueError(
                f"{kernel}: {block_name}={block} on {dim_name}={dim} is "
                f"not a multiple of the {q}-wide matrix-unit "
                f"tile{depth_hint}; pad {dim_name} to a multiple of {q} "
                "or use the XLA reference path for small shapes")


# ---------------------------------------------------------------------------
# TilePlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One kernel's chosen tiling on one device.

    ``blocks`` holds exactly the keyword arguments the ops-layer wrapper
    forwards to the kernel (``block_m``/``block_n``/``block_k``,
    ``block_q``/``block_kv``, ``chunk``); the perf engines record the
    same mapping in ``Report.plan`` so predicted and executed tiles can
    be cross-checked.
    """

    kernel: str
    device: str
    dtype: str
    blocks: Mapping[str, int]
    grid: Tuple[int, ...]
    vmem_bytes: int              # estimated per-core working set
    vmem_budget: int             # the budget it was sized against
    align: int
    padded: bool = False         # dims were rounded up (pad=True planning)
    #: dim name -> the (possibly padded) size the blocks tile.  With
    #: ``pad=True`` these are the quantum-rounded sizes the ops-layer
    #: wrappers pad inputs to (and slice outputs back from); with
    #: ``pad=False`` they equal the problem dims.
    dims: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def kwargs(self) -> Dict[str, int]:
        """The block keyword arguments for the ops-layer call."""
        return dict(self.blocks)

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"kernel": self.kernel, "device": self.device,
                                "dtype": self.dtype, "align": self.align,
                                "vmem_bytes": self.vmem_bytes}
        d.update(self.blocks)
        return d

    def describe(self) -> str:
        blk = " ".join(f"{k.replace('block_', 'b')}={v}"
                       for k, v in self.blocks.items())
        return (f"{self.kernel}@{self.device} {blk} "
                f"(vmem {self.vmem_bytes / 2**20:.2f}/"
                f"{self.vmem_budget / 2**20:.0f} MiB)")


# ---------------------------------------------------------------------------
# Planner internals
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Dim:
    """One plannable dim: kernel keyword, dim name, size, quantum class."""

    block_name: str
    dim_name: str
    size: int
    sublane: bool = False        # sublane- instead of MXU-quantised
    depth: bool = False          # contraction dim (full-depth step legal)


def _pad_to(dim: int, quantum: int) -> int:
    return quantum * math.ceil(dim / quantum)


def _candidates(kernel: str, d: _Dim, *, align: int,
                pad: bool) -> Tuple[int, Sequence[int]]:
    """(possibly padded size, descending quantum-aligned divisor blocks)."""
    q = SUBLANE if d.sublane else align
    size = _pad_to(d.size, q) if pad else d.size
    if size % q:
        if d.depth:
            # a single full-depth step streams the whole reduction in one
            # grid iteration: no unaligned tile boundary to misalign
            return size, [size]
        raise ValueError(
            f"{kernel}: {d.dim_name}={size} is not a multiple of the "
            f"{q}-wide tile quantum; pad {d.dim_name} (plan with pad=True "
            "to model padded execution) or use the XLA reference path")
    units = size // q
    return size, [u * q for u in range(units, 0, -1) if units % u == 0]


def _plan(kernel: str, spec: DeviceSpec, dtype, *,
          dims: Sequence[_Dim],
          caps: Mapping[str, int],
          footprint: Callable[[Mapping[str, int], int], int],
          grid: Callable[[Mapping[str, int], Mapping[str, int]], Tuple[int, ...]],
          overrides: Mapping[str, Optional[int]],
          pad: bool) -> TilePlan:
    """Shared planner body: choose quantum-aligned divisor blocks under
    the caps, shrink to the VMEM budget, validate, emit the plan."""
    align = tile_align(spec)
    budget = vmem_budget(spec)
    dsz = _itemsize(dtype)

    sizes: Dict[str, int] = {}           # dim name -> (padded) size
    cands: Dict[str, Sequence[int]] = {} # block name -> descending choices
    chosen: Dict[str, int] = {}
    for d in dims:
        size, c = _candidates(kernel, d, align=align, pad=pad)
        sizes[d.dim_name] = size
        cands[d.block_name] = c
        ov = overrides.get(d.block_name)
        if ov is not None:
            chosen[d.block_name] = ov
        else:
            cap = caps[d.block_name]
            chosen[d.block_name] = next((x for x in c if x <= cap), c[-1])

    # shrink the largest free block until the working set fits
    while footprint(chosen, dsz) > budget:
        shrinkable = [(v, k) for k, v in chosen.items()
                      if overrides.get(k) is None
                      and any(x < v for x in cands[k])]
        if not shrinkable:
            if any(v is not None for v in overrides.values()):
                break                      # caller pinned blocks: honour them
            raise ValueError(
                f"{kernel}: no tiling fits the {budget}-byte working-set "
                f"budget on {spec.name} (minimum aligned tiles need "
                f"{footprint(chosen, dsz)} bytes); raise the device's "
                "vmem_bytes or shrink the problem")
        _, k = max(shrinkable)
        chosen[k] = next(x for x in cands[k] if x < chosen[k])

    validate_tiling(
        kernel,
        {d.dim_name: (sizes[d.dim_name], chosen[d.block_name])
         for d in dims if not d.sublane},
        align=align,
        depth_dims=tuple(d.dim_name for d in dims if d.depth),
        block_names={d.dim_name: d.block_name for d in dims})
    validate_tiling(
        kernel,
        {d.dim_name: (sizes[d.dim_name], chosen[d.block_name])
         for d in dims if d.sublane},
        align=align, depth_dims=(), quantum=SUBLANE,
        block_names={d.dim_name: d.block_name for d in dims})

    return TilePlan(kernel=kernel, device=spec.name, dtype=str(dtype),
                    blocks=dict(chosen), grid=grid(sizes, chosen),
                    vmem_bytes=footprint(chosen, dsz), vmem_budget=budget,
                    align=align, padded=pad, dims=dict(sizes))


# ---------------------------------------------------------------------------
# Per-kernel planners
# ---------------------------------------------------------------------------

def _plan_mfma_gemm(shapes, dtype, spec, overrides, pad):
    M, N, K = shapes["M"], shapes["N"], shapes["K"]
    return _plan(
        "mfma_gemm", spec, dtype,
        dims=(_Dim("block_m", "M", M), _Dim("block_n", "N", N),
              _Dim("block_k", "K", K, depth=True)),
        caps={"block_m": 256, "block_n": 256, "block_k": 512},
        # A + B tiles in the operand dtype; C tile + f32 accumulator.
        footprint=lambda b, dsz: (b["block_m"] * b["block_k"] * dsz
                                  + b["block_k"] * b["block_n"] * dsz
                                  + 2 * b["block_m"] * b["block_n"] * 4),
        grid=lambda s, b: (s["M"] // b["block_m"], s["N"] // b["block_n"],
                           s["K"] // b["block_k"]),
        overrides=overrides, pad=pad)


def _plan_moe_gmm(shapes, dtype, spec, overrides, pad):
    E, C, K, N = shapes["E"], shapes["C"], shapes["K"], shapes["N"]
    return _plan(
        "moe_gmm", spec, dtype,
        dims=(_Dim("block_m", "C", C), _Dim("block_n", "N", N),
              _Dim("block_k", "K", K, depth=True)),
        caps={"block_m": 128, "block_n": 128, "block_k": 512},
        footprint=lambda b, dsz: (b["block_m"] * b["block_k"] * dsz
                                  + b["block_k"] * b["block_n"] * dsz
                                  + b["block_m"] * b["block_n"] * (dsz + 4)),
        grid=lambda s, b: (E, s["C"] // b["block_m"], s["N"] // b["block_n"],
                           s["K"] // b["block_k"]),
        overrides=overrides, pad=pad)


def _plan_flash_attention(shapes, dtype, spec, overrides, pad):
    B, S, T = shapes["B"], shapes["S"], shapes["T"]
    H, KV, hd = shapes["H"], shapes["KV"], shapes["hd"]
    return _plan(
        "flash_attention", spec, dtype,
        dims=(_Dim("block_q", "S", S), _Dim("block_kv", "T", T)),
        caps={"block_q": 512, "block_kv": 512},
        # q/o tiles + K and V tiles + f32 (acc, m, l) scratch.
        footprint=lambda b, dsz: (2 * b["block_q"] * hd * dsz
                                  + 2 * b["block_kv"] * hd * dsz
                                  + b["block_q"] * (hd + 2) * 4),
        grid=lambda s, b: (B * KV * (H // KV), s["S"] // b["block_q"],
                           s["T"] // b["block_kv"]),
        overrides=overrides, pad=pad)


def _plan_decode_attention(shapes, dtype, spec, overrides, pad):
    B, T = shapes["B"], shapes["T"]
    H, KV, hd = shapes["H"], shapes["KV"], shapes["hd"]
    G = H // KV
    return _plan(
        "decode_attention", spec, dtype,
        dims=(_Dim("block_kv", "T", T),),
        caps={"block_kv": 512},
        footprint=lambda b, dsz: (2 * G * hd * dsz
                                  + 2 * b["block_kv"] * hd * dsz
                                  + G * (hd + 2) * 4),
        grid=lambda s, b: (B * KV, s["T"] // b["block_kv"]),
        overrides=overrides, pad=pad)


def _plan_paged_decode_attention(shapes, dtype, spec, overrides, pad):
    """Same per-step geometry as ``decode_attention`` — one (G, block_kv)
    score tile and (m, l, acc) scratch — but ``block_kv`` doubles as the
    KV-pool page size.  An optional ``shapes["page"]`` pins ``block_kv``
    to an existing pool's page so plans always match pool geometry on
    every device; omit it (the reference's ``PagedKVCache``
    constructor does) to let the planner choose the page size."""
    B, T = shapes["B"], shapes["T"]
    H, KV, hd = shapes["H"], shapes["KV"], shapes["hd"]
    G = H // KV
    page = shapes.get("page")
    if page is not None and overrides.get("block_kv") is None:
        overrides = dict(overrides, block_kv=int(page))
    return _plan(
        "paged_decode_attention", spec, dtype,
        dims=(_Dim("block_kv", "T", T),),
        caps={"block_kv": 512},
        # q/o tiles + one K and one V page + f32 (m, l, acc) scratch.
        footprint=lambda b, dsz: (2 * G * hd * dsz
                                  + 2 * b["block_kv"] * hd * dsz
                                  + G * (hd + 2) * 4),
        grid=lambda s, b: (B * KV, s["T"] // b["block_kv"]),
        overrides=overrides, pad=pad)


def _plan_mamba2_ssd(shapes, dtype, spec, overrides, pad):
    B, S, nh = shapes["B"], shapes["S"], shapes["nh"]
    hd, ds = shapes["hd"], shapes["ds"]
    return _plan(
        "mamba2_ssd", spec, dtype,
        # the chunk feeds (Q x Q) intra-chunk matmuls; chunked SSD stays
        # exact at any chunk, so it is sublane- rather than MXU-quantised
        dims=(_Dim("chunk", "S", S, sublane=True),),
        caps={"chunk": 256},
        footprint=lambda b, dsz: (2 * b["chunk"] * hd * dsz
                                  + 2 * b["chunk"] * ds * dsz
                                  + b["chunk"] * (dsz + 4)
                                  + 3 * b["chunk"] * b["chunk"] * 4
                                  + hd * ds * 4),
        grid=lambda s, b: (B, nh, s["S"] // b["chunk"]),
        overrides=overrides, pad=pad)


# ---------------------------------------------------------------------------
# Hopper: the tiles the port's CUDA kernels run
# ---------------------------------------------------------------------------

def _wrapper(name: str):
    """A kernel's wrapper module, for its tile constants (the package
    re-exports each wrapper function under its module's name, so an
    attribute of the package would be the function)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _least_at_least(tiles: Sequence[int], n: int) -> int:
    """The smallest tile of ``tiles`` (ascending) holding ``n`` rows, else
    the largest."""
    return next((t for t in tiles if t >= n), tiles[-1])


def _hopper_dtype(kernel: str, dtype, spec: DeviceSpec) -> Tuple[str, int]:
    """(HLO name, bytes) of a dtype the CUDA kernels take: f32, bf16 or
    f16.  Any other raises :class:`UnknownDtypeError` (an unknown one as
    on every device)."""
    size = _itemsize(dtype)
    name = str(dtype).lower()
    name = name[len("torch."):] if name.startswith("torch.") else name
    name = _DTYPE_ALIASES.get(name, name)
    if name not in ("f32", "bf16", "f16"):
        raise UnknownDtypeError(
            f"{kernel}: the CUDA kernels on {spec.name} take f32, bf16 or "
            f"f16 operands, not {dtype!r}")
    return name, size


def _hopper_plan(kernel: str, spec: DeviceSpec, dtype, overrides, *,
                 blocks: Dict[str, int], dims: Dict[str, int],
                 grid: Tuple[int, ...], staged: int) -> TilePlan:
    """The plan of the tile a CUDA kernel runs: an override must name
    that tile (the kernels fix their own), and the staged operand tiles
    must fit one block's shared memory."""
    for k, v in overrides.items():
        if v != blocks.get(k):
            raise ValueError(
                f"{kernel}: {k}={v} is not the tile the CUDA kernel runs on "
                f"{spec.name} ({k}={blocks.get(k)}); the kernels fix their "
                "own tiles")
    budget = vmem_budget(spec)
    if staged > budget:
        raise ValueError(
            f"{kernel}: the CUDA kernel stages {staged} bytes of operand "
            f"tiles a block, over the {budget}-byte shared-memory budget "
            f"of {spec.name}")
    return TilePlan(kernel=kernel, device=spec.name, dtype=str(dtype),
                    blocks=blocks, grid=grid, vmem_bytes=staged,
                    vmem_budget=budget, align=tile_align(spec),
                    padded=False, dims=dims)


def _hopper_mfma_gemm(shapes, dtype, spec, overrides):
    """``wgmma`` blocks at M > ``DECODE_ROWS``, the decode ring's m16
    fragments at M <= ``DECODE_ROWS`` (bf16/f16 with K and N multiples of
    ``VECTOR``); else the 64 x 64 element-load or f32 blocks."""
    g = _wrapper("mfma_gemm")
    M, N, K = shapes["M"], shapes["N"], shapes["K"]
    name, size = _hopper_dtype("mfma_gemm", dtype, spec)
    if name != "f32" and K % g.VECTOR == 0 and N % g.VECTOR == 0:
        if M > g.DECODE_ROWS:
            bm, bn = g.WGMMA_ROWS, g.WGMMA_COLUMNS
        else:
            bm, bn = _least_at_least(g.DECODE_ROW_TILES, M), g.DECODE_COLUMNS
        bk, stages = g.BLOCK_K, g.STAGES
    else:
        bm, bn, bk, stages = g.TILE, g.TILE, g.TILE_K, 1
    return _hopper_plan(
        "mfma_gemm", spec, dtype, overrides,
        blocks={"block_m": bm, "block_n": bn, "block_k": bk},
        dims={"M": M, "N": N, "K": K},
        grid=(_cdiv(M, bm), _cdiv(N, bn), _cdiv(K, bk)),
        staged=stages * (bm * bk + bk * bn) * size)


def _hopper_moe_gmm(shapes, dtype, spec, overrides):
    """The ring (bf16/f16, K and N multiples of ``VECTOR``): a row tile
    sized to C by ``RING_COLUMNS`` columns; else ``gmm_kernel``'s 64 x 64."""
    g = _wrapper("moe_gmm")
    E, C, K, N = shapes["E"], shapes["C"], shapes["K"], shapes["N"]
    name, size = _hopper_dtype("moe_gmm", dtype, spec)
    if name != "f32" and K % g.VECTOR == 0 and N % g.VECTOR == 0:
        bm, bn = _least_at_least(g.RING_ROWS, C), g.RING_COLUMNS
        bk, stages = g.RING_K, g.RING_STAGES
    else:
        bm, bn, bk, stages = g.TILE, g.TILE, g.TILE_K, 1
    return _hopper_plan(
        "moe_gmm", spec, dtype, overrides,
        blocks={"block_m": bm, "block_n": bn, "block_k": bk},
        dims={"C": C, "N": N, "K": K},
        grid=(E, _cdiv(C, bm), _cdiv(N, bn), _cdiv(K, bk)),
        staged=stages * (bm * bk + bk * bn) * size)


def _hopper_flash_attention(shapes, dtype, spec, overrides):
    """``QUERY_ROWS`` query rows a block, keys in ``TILE``-row steps
    (a ring of ``STAGES`` K and V tiles on the tensor cores; one K or V
    tile and the f32 scores on the CUDA cores)."""
    f = _wrapper("flash_attention")
    B, S, T = shapes["B"], shapes["S"], shapes["T"]
    H, KV, hd = shapes["H"], shapes["KV"], shapes["hd"]
    name, size = _hopper_dtype("flash_attention", dtype, spec)
    if hd not in f.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{f.HEAD_DIMS}")
    if H % KV:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KV} KV heads")
    bq, bkv = f.QUERY_ROWS, f.TILE
    if name == "f32":
        staged = (bq * hd + bkv * hd + bq * bkv) * size
    else:
        staged = (bq + 2 * f.STAGES * bkv) * hd * size
    return _hopper_plan(
        "flash_attention", spec, dtype, overrides,
        blocks={"block_q": bq, "block_kv": bkv},
        dims={"S": S, "T": T}, grid=(B * H, _cdiv(S, bq), _cdiv(T, bkv)),
        staged=staged)


def _hopper_decode(kernel, shapes, dtype, spec, overrides):
    """Both decode kernels: ``TILE``-row steps in splits of
    ``kernel_split_rows(T, B * KV)`` rows, which the plain versions take
    as ``split_rows`` (the paged kernel's T is its table's capacity)."""
    d = _wrapper("decode_attention")
    B, T = shapes["B"], shapes["T"]
    H, KV, hd = shapes["H"], shapes["KV"], shapes["hd"]
    name, size = _hopper_dtype(kernel, dtype, spec)
    if hd % d.HD_QUANTUM or hd > d.MAX_HD:
        raise ValueError(f"{kernel}: head dim {hd} must be a multiple of "
                         f"{d.HD_QUANTUM} and at most {d.MAX_HD}")
    if H % KV:
        raise ValueError(f"{kernel}: {H} query heads do not group over "
                         f"{KV} KV heads")
    page = shapes.get("page")
    if page is not None and (page % d.PAGE_QUANTUM
                             or not d.PAGE_QUANTUM <= page <= d.MAX_PAGE):
        raise ValueError(f"{kernel}: page {page} must be a multiple of "
                         f"{d.PAGE_QUANTUM} rows between {d.PAGE_QUANTUM} "
                         f"and {d.MAX_PAGE}")
    rows = d.kernel_split_rows(T, B * KV)
    G = H // KV
    if name == "f32":
        staged = (2 * G * hd + G * d.TILE) * size
    else:
        staged = (G + 2 * d.STAGES * d.TILE) * hd * size
    return _hopper_plan(
        kernel, spec, dtype, overrides,
        blocks={"block_kv": d.TILE, "split_rows": rows}, dims={"T": T},
        grid=(B * KV, _cdiv(T, rows)), staged=staged)


def _hopper_decode_attention(shapes, dtype, spec, overrides):
    return _hopper_decode("decode_attention", shapes, dtype, spec,
                          overrides)


def _hopper_paged_decode_attention(shapes, dtype, spec, overrides):
    return _hopper_decode("paged_decode_attention", shapes, dtype, spec,
                          overrides)


def _hopper_mamba2_ssd(shapes, dtype, spec, overrides):
    """Chunks of ``CHUNK`` rows, every chunk in parallel: a chunk's x, B
    and C rows and its f32 scores."""
    m = _wrapper("mamba2_ssd")
    B, S, nh = shapes["B"], shapes["S"], shapes["nh"]
    hd, ds = shapes["hd"], shapes["ds"]
    _, size = _hopper_dtype("mamba2_ssd", dtype, spec)
    if ds not in m.D_STATES:
        raise ValueError(f"mamba2_ssd: state size ds={ds} not in "
                         f"{m.D_STATES}")
    if hd < m.HD_QUANTUM or hd % m.HD_QUANTUM:
        raise ValueError(f"mamba2_ssd: head dim hd={hd} is not a positive "
                         f"multiple of {m.HD_QUANTUM}")
    q = m.CHUNK
    return _hopper_plan(
        "mamba2_ssd", spec, dtype, overrides, blocks={"chunk": q},
        dims={"S": S}, grid=(B, nh, _cdiv(S, q)),
        staged=(q * hd + 2 * q * ds) * size + q * q * 4)


# ---------------------------------------------------------------------------
# Catalog
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One enumerable kernel: op entry point, oracle, planner, blocks."""

    name: str
    op: str                      # "module:attr" of the ops-layer wrapper
    ref: str                     # "module:attr" of the jnp oracle
    planner: Callable
    block_names: Tuple[str, ...]
    doc: str = ""
    #: Mesh-eligibility contract: problem dim -> logical axis name
    #: (``parallel.api`` rules).  Dims sharing a logical axis co-shard;
    #: dims absent here stay replicated under ``shard_map``.  ``None``
    #: means the kernel has no sharded execution path and dispatch keeps
    #: the legacy whole-op fallback on a mesh.  Plain strings only — the
    #: catalog stays importable without torch.
    logical: Optional[Mapping[str, str]] = None
    #: The H100's planner: the tile the port's CUDA kernel runs, taking
    #: (shapes, dtype, spec, overrides).  ``None``: no CUDA kernel, and
    #: planning on Hopper raises.
    hopper: Optional[Callable] = None

    def _resolve(self, target: str):
        mod, attr = target.split(":")
        return getattr(importlib.import_module(mod), attr)

    @property
    def op_fn(self):
        return self._resolve(self.op)

    @property
    def ref_fn(self):
        return self._resolve(self.ref)


_CATALOG: Dict[str, KernelEntry] = {}


def register_kernel(entry: KernelEntry, *,
                    replace: bool = False) -> KernelEntry:
    if entry.name in _CATALOG and not replace:
        raise ValueError(f"kernel {entry.name!r} is already registered")
    _CATALOG[entry.name] = entry
    return entry


def get_kernel(name: str) -> KernelEntry:
    try:
        return _CATALOG[name]
    except KeyError:
        raise UnknownKernelError(
            f"unknown kernel {name!r}; registered: {sorted(_CATALOG)}"
        ) from None


def list_kernels() -> Sequence[str]:
    return sorted(_CATALOG)


# ---------------------------------------------------------------------------
# plan_for
# ---------------------------------------------------------------------------

def _as_spec(device) -> DeviceSpec:
    if device is None:
        return get_device(DEFAULT_PLAN_DEVICE)
    if isinstance(device, DeviceSpec):
        return device
    spec = getattr(device, "spec", None)      # MachineModel duck-type
    if isinstance(spec, DeviceSpec):
        return spec
    return get_device(str(device))


def plan_for(kernel: str, shapes: Mapping[str, int], *,
             dtype="bfloat16",
             device: Union[None, str, DeviceSpec, object] = None,
             pad: bool = False,
             **overrides: Optional[int]) -> TilePlan:
    """Derive the tile plan for ``kernel`` on ``device``.

    ``shapes`` names the kernel's problem dims (``mfma_gemm`` wants
    M/N/K, ``moe_gmm`` E/C/K/N, ``flash_attention`` B/S/T/H/KV/hd,
    ``decode_attention`` B/T/H/KV/hd, ``mamba2_ssd`` B/S/nh/hd/ds).
    ``device`` is a registry name, a :class:`DeviceSpec`, or anything
    with a ``.spec`` (a ``MachineModel``); ``None`` plans for
    ``DEFAULT_PLAN_DEVICE``.  ``pad=True`` rounds dims up to the
    alignment quantum first — the perf engines use this to model padded
    execution of arbitrary HLO dots; the execution path leaves it off so
    misaligned shapes raise.  Keyword overrides (``block_m=...``) pin
    individual blocks, which are then validated rather than chosen.

    On the H100 (``HOPPER``) the plan is the tile the port's CUDA kernel
    runs; ``pad`` changes nothing there (the kernels mask ragged edges)
    and an override must name that tile.
    """
    entry = get_kernel(kernel)
    spec = _as_spec(device)
    overrides = {k: v for k, v in overrides.items() if v is not None}
    unknown = set(overrides) - set(entry.block_names)
    if unknown:
        raise ValueError(f"{kernel}: unknown block override(s) "
                         f"{sorted(unknown)}; expected {entry.block_names}")
    if spec.family == HOPPER:
        if entry.hopper is None:
            raise ValueError(f"{kernel}: no CUDA kernel to plan on "
                             f"{spec.name}")
        return entry.hopper(dict(shapes), dtype, spec, overrides)
    return entry.planner(dict(shapes), dtype, spec, overrides, pad)


for _entry in (
    KernelEntry(
        name="mfma_gemm", op="repro_torch.kernels.mfma_gemm:mfma_gemm",
        ref="repro_torch.kernels.mfma_gemm:mfma_gemm_plain",
        planner=_plan_mfma_gemm,
        hopper=_hopper_mfma_gemm,
        block_names=("block_m", "block_n", "block_k"),
        doc="MXU-tiled accumulate-GEMM D = C + A @ B (the MFMA contract)"),
    KernelEntry(
        name="moe_gmm", op="repro_torch.kernels.moe_gmm:moe_gmm",
        ref="repro_torch.kernels.moe_gmm:moe_gmm_plain",
        planner=_plan_moe_gmm,
        hopper=_hopper_moe_gmm,
        block_names=("block_m", "block_n", "block_k"),
        doc="grouped per-expert matmul (E, C, K) @ (E, K, N)",
        logical={"E": "expert"}),
    KernelEntry(
        name="flash_attention",
        op="repro_torch.kernels.flash_attention:flash_attention",
        ref="repro_torch.kernels.flash_attention:flash_attention_plain",
        planner=_plan_flash_attention,
        hopper=_hopper_flash_attention,
        block_names=("block_q", "block_kv"),
        doc="blockwise online-softmax causal GQA attention",
        logical={"B": "batch", "H": "heads", "KV": "heads"}),
    KernelEntry(
        name="decode_attention",
        op="repro_torch.kernels.decode_attention:decode_attention",
        ref="repro_torch.kernels.decode_attention:decode_attention_plain",
        planner=_plan_decode_attention,
        hopper=_hopper_decode_attention,
        block_names=("block_kv",),
        doc="flash-decode: one query token vs a long KV cache",
        logical={"B": "batch", "H": "heads", "KV": "heads"}),
    KernelEntry(
        name="paged_decode_attention",
        op="repro_torch.kernels.decode_attention:paged_decode_attention",
        ref="repro_torch.kernels.decode_attention:paged_decode_attention_plain",
        planner=_plan_paged_decode_attention,
        hopper=_hopper_paged_decode_attention,
        block_names=("block_kv",),
        doc="flash-decode over a block-paged KV pool via a block table"),
    KernelEntry(
        name="mamba2_ssd", op="repro_torch.kernels.mamba2_ssd:mamba2_ssd",
        ref="repro_torch.kernels.mamba2_ssd:mamba2_ssd_plain",
        planner=_plan_mamba2_ssd,
        hopper=_hopper_mamba2_ssd,
        block_names=("chunk",),
        doc="chunked SSD (Mamba2): quadratic intra-chunk, linear across",
        logical={"B": "batch", "nh": "heads", "G": "heads"}),
):
    register_kernel(_entry)
