#!/usr/bin/env python
"""Lint every registered ``repro_torch.arch`` DeviceSpec (twin of
``scripts/check_device_specs.py``, which CI runs on the reference).

Checks, per device (the reference's, unchanged, for its five devices):
  * positive clock, sane topology (>=1 CU/SIMD; MXU dims positive);
  * every cycle-table instruction exists in the MFMA registry, with
    positive integer cycles and a boolean ``validated`` flag;
  * known dtypes: every instruction's operand dtype is one the
    instruction-selection policy can map from HLO;
  * validated-flag provenance: entries claiming ``validated=True`` must
    match the paper's measured tables (mi200/mi300);
  * no s_set_gpr_idx-mode instruction carries a timing entry;
  * bandwidths/links are non-negative, and an advertised peak stays
    within 4x of the spec-derived peak;
  * serveability: the device admits a ``paged_decode_attention`` tile
    plan (:mod:`repro_torch.kernels.plan`) for a production GQA
    geometry.

A Hopper device (``family == "nvidia-hopper"``, the H100) has no MFMA
cycle table and no MXUs: its matrix path is the tensor cores, which the
port's CUDA kernels drive, and its cycle table stays empty.  For it
three of the reference's checks (a cycle table or MXUs, at least 1 MiB
of VMEM, a peak derived from the cycle table) are replaced by:
  * the advertised ``peak_flops`` is positive and within 4x of the dense
    bf16 rate derived from the spec's SM count, tensor cores an SM and
    clock (``HOPPER_BF16_FLOPS_PER_CLOCK`` a tensor core);
  * one block's shared memory (``vmem_bytes``) holds the ``mfma_gemm``
    ``wgmma`` ring, as the planner's Hopper plan reads it from the
    wrapper's constants.

Then every device must yield a finite, feasible capacity frontier for
every built-in traffic scenario (:mod:`repro_torch.fleet`).

Exit code 0 = catalog clean; 1 = violations (printed one per line).

    PYTHONPATH=src python scripts/torch_check_device_specs.py
"""

from __future__ import annotations

import pathlib
import sys
from typing import List, Optional, Sequence

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.arch import HLO_DTYPE_TO_IN, get_device, list_devices  # noqa: E402
from repro_torch.arch.registry import MI200_CYCLES, MI300_CYCLES  # noqa: E402
from repro_torch.arch.spec import DeviceSpec  # noqa: E402
from repro_torch.core import isa  # noqa: E402
from repro_torch.kernels.plan import HOPPER, plan_for  # noqa: E402

# The serve layer's page-size probe geometry: a dense production GQA
# head layout (32 query / 8 KV heads of 128) over a 512-token probe.
_PAGED_PROBE = {"B": 1, "T": 512, "H": 32, "KV": 8, "hd": 128}

# A prefill-sized GEMM: ``mfma_gemm`` takes its ``wgmma`` ring there.
_GEMM_PROBE = {"M": 4096, "N": 4096, "K": 4096}

#: Dense bf16 flops a Hopper tensor core retires a clock (512 FMAs; the
#: H100 data sheet's 989 TFLOP/s = 132 SMs x 4 x 1024 x 1.83 GHz).
HOPPER_BF16_FLOPS_PER_CLOCK = 1024

# The hardware-measured ground truth (paper Tables II-V): only these
# (device, instr) pairs may carry validated=True.
_VALIDATED_GROUND_TRUTH = {
    ("mi200", name): cycles
    for name, (cycles, v) in MI200_CYCLES.items() if v
}
_VALIDATED_GROUND_TRUTH.update({
    ("mi300", name): cycles
    for name, (cycles, v) in MI300_CYCLES.items() if v
})

_KNOWN_IN_DTYPES = set(HLO_DTYPE_TO_IN.values())


def hopper_bf16_flops(spec: DeviceSpec) -> float:
    """The dense bf16 tensor-core rate of a Hopper spec: SMs x tensor
    cores an SM x flops a clock x clock."""
    return (spec.cu_count * spec.simd_per_cu * spec.mce_per_simd
            * HOPPER_BF16_FLOPS_PER_CLOCK * spec.clock_mhz * 1e6)


def _hopper_matrix_path(spec: DeviceSpec, err) -> None:
    derived = hopper_bf16_flops(spec)
    if spec.peak_flops <= 0:
        err("peak_flops must be positive: the tensor cores are the matrix "
            "path and the roofline reads their advertised rate")
    elif not derived / 4 <= spec.peak_flops <= derived * 4:
        err(f"advertised peak {spec.peak_flops:.3g} FLOP/s is >4x off the "
            f"dense bf16 tensor-core rate {derived:.3g} derived from "
            f"{spec.cu_count} SMs x {spec.simd_per_cu * spec.mce_per_simd} "
            f"tensor cores x {HOPPER_BF16_FLOPS_PER_CLOCK} flop/clock at "
            f"{spec.clock_mhz:g} MHz")
    if spec.vmem_bytes <= 0:
        err("vmem_bytes must be positive (one block's shared memory)")
        return
    try:
        plan_for("mfma_gemm", _GEMM_PROBE, dtype="bfloat16", device=spec)
    except ValueError as e:
        err(f"vmem_bytes={spec.vmem_bytes} cannot hold the mfma_gemm wgmma "
            f"ring: {e}")


def check_spec(name: str, spec: Optional[DeviceSpec] = None) -> List[str]:
    """The violations of device ``name`` (its registered spec, or
    ``spec``), one message each."""
    spec = spec if spec is not None else get_device(name)
    hopper = spec.family == HOPPER
    errs: List[str] = []

    def err(msg):
        errs.append(f"{name}: {msg}")

    if spec.clock_mhz <= 0:
        err(f"non-positive clock {spec.clock_mhz}")
    if spec.cu_count < 1 or spec.simd_per_cu < 1 or spec.mce_per_simd < 1:
        err("topology must have >=1 CU/SIMD/MCE")
    if spec.mxu_count < 0 or (spec.mxu_count and spec.mxu_dim < 1):
        err("bad MXU configuration")
    if hopper:
        _hopper_matrix_path(spec, err)
    else:
        if not spec.has_cycle_table and not spec.mxu_count:
            err("neither a cycle table nor MXUs: no matrix path at all")
        # The kernel tile planner budgets block working sets against this;
        # a catalog device must be plannable (>= one aligned GEMM tile set).
        if spec.vmem_bytes <= 0:
            err("vmem_bytes must be positive (kernel tile-planning budget)")
        elif spec.vmem_bytes < 1 << 20:
            err(f"vmem_bytes={spec.vmem_bytes} cannot hold one MXU-aligned "
                "GEMM tile set (needs >= 1 MiB)")

    mem, ic = spec.memory, spec.interconnect
    for f in ("l1i_latency", "l1d_latency", "scalar_latency", "lds_latency",
              "l2_latency", "mem_latency", "valu_latency"):
        if getattr(mem, f) < 0:
            err(f"negative {f}")
    for f, v in (("l2_bw", mem.l2_bw), ("lds_bw", mem.lds_bw)):
        if v < 0:
            err(f"negative {f}")
    # hbm_bw/link_bw must be strictly positive: the roofline divides by
    # them.
    if mem.hbm_bw <= 0:
        err("hbm_bw must be positive (roofline memory term)")
    if ic.link_bw <= 0:
        err("link_bw must be positive (roofline collective term)")
    if ic.links < 1:
        err("interconnect needs >=1 link")

    for instr, entry in spec.cycle_table.items():
        meta = isa.MFMA_REGISTRY.get(instr)
        if meta is None:
            err(f"cycle table names unknown instruction {instr!r}")
            continue
        if not isinstance(entry.cycles, int) or entry.cycles < 1:
            err(f"{instr}: cycles must be a positive int, "
                f"got {entry.cycles!r}")
        if not isinstance(entry.validated, bool):
            err(f"{instr}: validated flag must be bool, "
                f"got {entry.validated!r}")
        if meta.in_dtype not in _KNOWN_IN_DTYPES:
            err(f"{instr}: operand dtype {meta.in_dtype!r} has no HLO "
                "mapping in the selection policy")
        if meta.gpr_idx_mode:
            err(f"{instr}: s_set_gpr_idx-mode instructions are not "
                "executable by the timing model (Section VI)")
        if entry.validated:
            truth = _VALIDATED_GROUND_TRUTH.get((name, instr))
            if truth is None:
                err(f"{instr}: claims validated=True but ({name}, {instr}) "
                    "is not in the paper's measured tables")
            elif truth != entry.cycles:
                err(f"{instr}: validated entry is {entry.cycles} cycles "
                    f"but the paper measured {truth}")

    if not hopper:
        # Peak must be derivable for every device with a matrix model (the
        # roofline and bridge call it unconditionally).
        try:
            derived = spec.peak_matrix_tflops * 1e12
        except Exception as e:  # noqa: BLE001 - any failure is a catalog bug
            err(f"cannot derive peak matrix throughput: {e}")
            derived = None
        if spec.peak_flops and derived:
            if not (derived / 4 <= spec.peak_flops <= derived * 4):
                err(f"advertised peak {spec.peak_flops:.3g} FLOP/s is >4x "
                    f"off the spec-derived {derived:.3g}")

    # Serveability: the paged-decode planner must find a page size within
    # this device's budget, or the paged engine cannot be sized for it.
    for dt in ("bfloat16", "float32"):
        try:
            plan = plan_for("paged_decode_attention", _PAGED_PROBE,
                            dtype=dt, device=spec)
        except Exception as e:  # noqa: BLE001 - any failure is a catalog bug
            err(f"no valid paged-decode plan for {dt} "
                f"(serve-layer page probe): {e}")
            continue
        page = plan.blocks.get("block_kv", 0)
        if page < 1 or _PAGED_PROBE["T"] % page:
            err(f"paged-decode plan for {dt} picked page {page}, which "
                f"does not tile the T={_PAGED_PROBE['T']} probe")
    return errs


def check_fleet_frontier(names: Sequence[str]) -> List[str]:
    """Every registered device must yield a finite, feasible capacity
    frontier for every built-in traffic scenario."""
    import math

    from repro_torch.fleet import frontier, list_scenarios

    errs = []
    rep = frontier(list_scenarios(), tuple(names))
    for r in rep.rows:
        where = f"{r.device}: scenario {r.scenario!r}"
        if not (math.isfinite(r.decode_tick_ms) and r.decode_tick_ms > 0):
            errs.append(f"{where} has a non-finite decode tick "
                        f"({r.decode_tick_ms})")
        elif not r.feasible:
            errs.append(f"{where} is infeasible under its SLO "
                        f"(decode tick {r.decode_tick_ms:.2f}ms vs "
                        f"p99 target {r.slo_p99_ms:g}ms)")
        elif not math.isfinite(r.cost_per_mtok):
            errs.append(f"{where} yields a non-finite cost per token")
    return errs


def main() -> int:
    failures = []
    names = list(list_devices())
    for name in names:
        failures += check_spec(name)
    failures += check_fleet_frontier(names)
    for f in failures:
        print(f"FAIL {f}")
    print(f"checked {len(names)} device specs "
          f"({', '.join(names)}) + fleet frontiers: "
          f"{'OK' if not failures else f'{len(failures)} violations'}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
