"""The paper's Listing-1 microbenchmark on the card's tensor cores: the
wrapper around ``csrc/listing1.cu``, its plain PyTorch version, and the
Eq. 1 reading of its stamps.

The reference runs Listing 1 only on its simulator
(``repro.core.microbench.build_listing1``); the paper ran the same
stream on MI200 and MI300 hardware and recovered each MFMA's latency
from its two ``s_memtime`` stamps with Eq. 1.  This probe does that step
on the H100: one warp reads ``%clock64``, issues N dependent
``mma.sync`` (each one's D the next one's C) and reads ``%clock64``
again without waiting for the last one, so::

    T_total = end - start = (N - 1) T_mma + T_probe

and :func:`repro_torch.core.microbench.eq1_latency`, given a machine
whose ``t_memtime`` is the N = 0 stream's T_total (the probe overhead)
and whose ``t_inst`` is 0, returns T_mma (:func:`eq1_cycles`).

One variant per operand type of the paper's validated set (``KINDS``):
f64 ``m8n8k4``, tf32 ``m16n8k8`` (f32 operands), f16 and bf16
``m16n8k16`` into f32, s8 ``m16n8k32`` into s32.  ``wgmma`` is left out:
its asynchronous issue, waited on with a fence, does not give Listing
1's in-order chain.  The cycles it measures are the H100's, printed and
recorded; nothing in the timing model reads them (the H100's
``cycle_table`` stays empty: its keys are AMD's instructions).

* On a CUDA tensor :func:`listing1` launches the kernel (built on first
  use) or raises; it never runs the plain version in its place.
* On a CPU tensor it runs :func:`listing1_plain` and has no stamps.

The plain version is D = C + N A B, summed in float64 and rounded once
to C's dtype.  The kernel rounds each mma's sum
to f32 (s32 exact); the two are equal when every partial sum is exact
in f32, as for the small integer-valued operands of :func:`operands`.

``LAUNCHES`` counts kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import dataclasses
import statistics
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["KINDS", "MAX_N", "LAUNCHES", "Kind", "listing1",
           "listing1_plain", "operands", "t_total", "stream_cycles",
           "eq1_cycles", "least_squares_slope"]

NAME = "listing1"
LAUNCHES: Dict[str, int] = {NAME: 0}
MAX_N = 8                        # the kernel's longest chain (kMaxN)
N_STAMPS = 34                    # start, end, and one fold word a lane


@dataclasses.dataclass(frozen=True)
class Kind:
    """One variant of the probe: its ``mma.sync`` shape and types."""

    code: int                    # the kernel's kind code
    ptx: str                     # the instruction it chains
    m: int
    n: int
    k: int
    ab: torch.dtype              # A and B
    cd: torch.dtype              # C and D


KINDS: Dict[str, Kind] = {
    "f64": Kind(0, "mma.sync.m8n8k4.f64.f64.f64.f64", 8, 8, 4,
                torch.float64, torch.float64),
    "tf32": Kind(1, "mma.sync.m16n8k8.f32.tf32.tf32.f32", 16, 8, 8,
                 torch.float32, torch.float32),
    "f16": Kind(2, "mma.sync.m16n8k16.f32.f16.f16.f32", 16, 8, 16,
                torch.float16, torch.float32),
    "bf16": Kind(3, "mma.sync.m16n8k16.f32.bf16.bf16.f32", 16, 8, 16,
                 torch.bfloat16, torch.float32),
    "s8": Kind(4, "mma.sync.m16n8k32.s32.s8.s8.s32", 16, 8, 32,
               torch.int8, torch.int32),
}

_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6)


def _kind_of(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> str:
    for name, kind in KINDS.items():
        if a.dtype == kind.ab:
            break
    else:
        raise ValueError(f"{NAME}: no variant takes a/b of {a.dtype}; "
                         f"kinds: {list(KINDS)}")
    want = ((kind.m, kind.k), (kind.k, kind.n), (kind.m, kind.n))
    got = (tuple(a.shape), tuple(b.shape), tuple(c.shape))
    if got != want or b.dtype != kind.ab or c.dtype != kind.cd:
        raise ValueError(
            f"{NAME}: the {name} variant takes a{want[0]} b{want[1]} "
            f"{kind.ab} and c{want[2]} {kind.cd}; got a{got[0]} {a.dtype}, "
            f"b{got[1]} {b.dtype}, c{got[2]} {c.dtype}")
    if b.device != a.device or c.device != a.device:
        raise ValueError(f"{NAME}: all operands must be on {a.device}, got "
                         f"{b.device} and {c.device}")
    return name


def _chain_length(n: int) -> None:
    if not 0 <= n <= MAX_N:
        raise ValueError(f"{NAME}: chain length {n} is outside [0, {MAX_N}]")


def listing1_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   n: int) -> torch.Tensor:
    """D = C + n A B, summed in float64 (exact for every s8 variant's
    operands, |D| < 2**53) and rounded once to C's dtype."""
    _kind_of(a, b, c)
    _chain_length(n)
    return (c.double() + n * (a.double() @ b.double())).to(c.dtype)


def listing1(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, n: int):
    """One Listing-1 stream of ``n`` chained ``mma.sync`` over a (m, k),
    b (k, n) and c (m, n) of one of ``KINDS``: returns ``(d, stamps)``,
    ``stamps`` an int64 tensor ``[start, end]`` of ``%clock64`` readings
    on the card (None on the CPU, where the plain version runs).
    Raises ``ValueError`` for operands no variant takes."""
    build.no_grad_operands(NAME, a, b, c)
    _kind_of(a, b, c)
    _chain_length(n)
    if a.device.type == "cpu":
        return listing1_plain(a, b, c, n), None
    if a.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {a.device}")
    d, stamps = _launch(a.contiguous(), b.contiguous(), c.contiguous(), n)
    return d, stamps[:2]


def _launch(a, b, c, n: int, d=None, stamps=None):
    """Launch into ``d`` and ``stamps`` (fresh when None); returns both."""
    kind = KINDS[_kind_of(a, b, c)]
    if d is None:
        d = torch.empty_like(c)
    if stamps is None:
        stamps = torch.empty(N_STAMPS, dtype=torch.int64, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    build.launch(NAME, _ARGS, kind.code, n, a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), d.data_ptr(), stamps.data_ptr(), stream,
                 device=a.device)
    LAUNCHES[NAME] += 1
    return d, stamps


def operands(kind: str, *, seed: int = 0, device="cuda"):
    """Integer-valued a, b in [-2, 2] and c in [-8, 8] for ``kind``, drawn
    with numpy from ``seed``: every sum of a chain of up to ``MAX_N``
    products is exact in f32 (|D| <= 8 + 8 x 4 k <= 1032), so the kernel
    must equal :func:`listing1_plain` exactly."""
    spec = KINDS[kind]
    rng = np.random.default_rng(seed)

    def draw(shape, lim, dtype):
        x = rng.integers(-lim, lim + 1, size=shape)
        return torch.from_numpy(x).to(dtype).to(device)

    return (draw((spec.m, spec.k), 2, spec.ab),
            draw((spec.k, spec.n), 2, spec.ab),
            draw((spec.m, spec.n), 8, spec.cd))


def t_total(stamps) -> int:
    """end - start, Listing 1's ``total``, in the SM's clock cycles."""
    start, end = (int(x) for x in stamps[:2])
    return end - start


def stream_cycles(kind: str, n: int, *, launches: int = 50, seed: int = 0,
                  device="cuda"):
    """``launches`` launches of ``kind``'s stream at chain length ``n`` on
    one set of :func:`operands`, back to back on the current stream and
    synchronised once.  Returns ``(median T_total, totals, ds, want)``:
    every launch's T_total, every launch's D stacked, and the plain D."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"{NAME}: the stream's cycles are read on the "
                         f"card; got device {device}")
    a, b, c = operands(kind, seed=seed, device=device)
    ds = torch.empty((launches, *c.shape), dtype=c.dtype, device=a.device)
    stamps = torch.empty((launches, N_STAMPS), dtype=torch.int64,
                         device=a.device)
    for i in range(launches):
        _launch(a, b, c, n, ds[i], stamps[i])
    torch.cuda.synchronize(a.device)
    totals = [t_total(row) for row in stamps.cpu()]
    return (statistics.median(totals), totals, ds,
            listing1_plain(a, b, c, n))


def eq1_cycles(medians: Dict[int, float], *,
               t_inst: float = 0.0) -> Dict[int, float]:
    """Eq. 1 on the card's medians ``{N: T_total}`` (N = 0 the probe
    overhead): ``eq1_latency(T_N, N, machine)`` for every N >= 2, the
    machine the H100's with ``t_memtime`` the overhead and ``t_inst``
    as given (0 by default; the N = 1 stream's T_total less the
    overhead is the card's issue cost of the last mma)."""
    from repro_torch.core.machine import get_machine
    from repro_torch.core.microbench import eq1_latency
    machine = dataclasses.replace(get_machine("h100"),
                                  t_memtime=medians[0], t_inst=t_inst)
    return {n: eq1_latency(t, n, machine) for n, t in medians.items()
            if n >= 2}


def least_squares_slope(medians: Dict[int, float]) -> float:
    """The least-squares slope of T_total over the medians' N >= 2:
    cycles per chained mma, with the probe overhead and the last mma's
    issue in the intercept."""
    ns = sorted(n for n in medians if n >= 2)
    x = np.array(ns, dtype=np.float64)
    y = np.array([medians[n] for n in ns], dtype=np.float64)
    return float(np.polyfit(x, y, 1)[0])
