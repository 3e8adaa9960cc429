"""Listing-1 construction, Eq. 1, the GEMM tile loops and the plan
throughput against the reference (twin of ``tests/test_microbench.py``),
and the Listing-1 probe's plain version and Eq. 1 helpers
(``repro_torch.kernels.listing1``) against numpy and by hand."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from _torch_timing import TABLE_DEVICES, machines
from repro.core import microbench as ref_mb
from repro.core import program as ref_program
from repro.kernels.plan import plan_for
from repro_torch.core import isa
from repro_torch.core.machine import get_machine
from repro_torch.core.microbench import (build_listing1, eq1_latency,
                                         gemm_stream, latency_table,
                                         measure_latency,
                                         measure_plan_throughput,
                                         plan_microops, simulate_gemm_cu,
                                         t_total)
from repro_torch.core.scoreboard import simulate_program

M = get_machine("mi200")
probe = importlib.import_module("repro_torch.kernels.listing1")


def test_listing1_structure():
    prog = build_listing1("fp32_4x4x1fp32", 4, padding_nops=2)
    ops = [i.opcode for i in prog]
    assert ops == ["s_waitcnt", "s_nop", "s_nop", "s_memtime",
                   "mfma", "mfma", "mfma", "mfma", "s_memtime", "s_waitcnt"]


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("pad", [0, 3])
def test_listing1_stream_equals_reference(n, pad):
    """Instruction for instruction: opcode, registers, MFMA and tag."""
    got = build_listing1("fp32_16x16x16fp16", n, padding_nops=pad)
    want = ref_mb.build_listing1("fp32_16x16x16fp16", n, padding_nops=pad)
    assert [dataclasses.astuple(i) for i in got] == \
        [dataclasses.astuple(i) for i in want]


def test_listing1_needs_two_mfma():
    """The final MFMA isn't waited on (no data dep on s_memtime) — one
    MFMA alone is unmeasurable (Section IV-C)."""
    with pytest.raises(ValueError, match="need >= 2 MFMAs"):
        build_listing1("fp32_4x4x1fp32", 1)


def test_eq1_roundtrip():
    for name, lat in [("fp32_4x4x1fp32", 8), ("fp64_16x16x4fp64", 32)]:
        for n in (2, 3, 4, 5):
            assert measure_latency(M, name, n) == lat


def test_final_mfma_not_counted():
    """T_total includes only (N-1) MFMAs + probe overhead: the second
    s_memtime doesn't wait for the last MFMA (scalar pipe independence)."""
    res = simulate_program(M, build_listing1("fp32_16x16x4fp32", 3))
    assert res.by_tag("end").issue < res.by_tag("mfma2").complete
    assert t_total(res) == 2 * 32 + M.t_memtime + M.t_inst


def test_eq1_formula_direct():
    assert eq1_latency(2 * 32 + M.t_memtime + M.t_inst, 3, M) == 32
    ref_m = machines("mi200")[1]
    for total, n in ((100, 2), (137, 4), (64, 3)):
        assert eq1_latency(total, n, M) == ref_mb.eq1_latency(total, n, ref_m)


@pytest.mark.parametrize("name", TABLE_DEVICES)
@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
def test_latency_table_equals_reference_on_every_instruction(name, scale):
    """Every supported instruction (not only the validated set), N 2..6."""
    port, ref = machines(name, mfma_scale=scale)
    instrs = port.supported_instructions()
    assert latency_table(port, instrs, range(2, 7)) == \
        ref_mb.latency_table(ref, instrs, range(2, 7))


@pytest.mark.parametrize("name", TABLE_DEVICES)
def test_listing1_simulation_equals_reference(name):
    port, ref = machines(name)
    for instr in port.supported_instructions():
        for n, pad in ((2, 0), (4, 5)):
            got = simulate_program(port, build_listing1(instr, n,
                                                        padding_nops=pad))
            want = ref_mb.simulate_program(ref, ref_mb.build_listing1(
                instr, n, padding_nops=pad))
            assert [dataclasses.astuple(r) for r in got.records] == \
                [dataclasses.astuple(r) for r in want.records]
            assert got.regs == want.regs and got.finish == want.finish


def test_gemm_stream_equals_reference():
    got = gemm_stream("fp32_16x16x16fp16", 5, 3)
    want = ref_mb.gemm_stream("fp32_16x16x16fp16", 5, 3)
    assert [dataclasses.astuple(i) for i in got] == \
        [dataclasses.astuple(i) for i in want]


@pytest.mark.parametrize("name", TABLE_DEVICES)
@pytest.mark.parametrize("tiles,n_wf", [(1, 1), (8, 8), (3, 5), (4, 12)])
def test_simulate_gemm_cu_equals_reference(name, tiles, n_wf):
    port, ref = machines(name)
    for instr in ("fp32_16x16x16fp16", "fp64_16x16x4fp64"):
        got = simulate_gemm_cu(port, instr, tiles_per_wf=tiles, n_wf=n_wf)
        assert got == ref_mb.simulate_gemm_cu(ref, instr, tiles_per_wf=tiles,
                                              n_wf=n_wf)
    # by name too, the scoreboard's coercion
    assert simulate_gemm_cu(name, "fp32_16x16x16fp16") == \
        ref_mb.simulate_gemm_cu(name, "fp32_16x16x16fp16")


def test_gemm_cu_reaches_full_mce_utilization():
    out = simulate_gemm_cu(M, "fp32_16x16x16fp16", tiles_per_wf=8, n_wf=8)
    assert out["mce_utilization"] == 1.0
    assert out["makespan"] == out["analytic_cycles"]


PLAN_SHAPES = [{"M": 256, "N": 256, "K": 256},
               {"M": 1024, "N": 512, "K": 2048},
               {"M": 128, "N": 384, "K": 128}]


@pytest.mark.parametrize("shapes", PLAN_SHAPES)
@pytest.mark.parametrize("name", TABLE_DEVICES)
def test_plan_microops_and_throughput_equal_reference(shapes, name):
    """The reference planner's TilePlan, read by both packages."""
    plan = plan_for("mfma_gemm", shapes, device=name)
    port, ref = machines(name)
    for instr in port.supported_instructions():
        assert plan_microops(plan, instr) == ref_mb.plan_microops(plan, instr)
        for cap in (1, 4, 16):
            assert measure_plan_throughput(port, instr, plan,
                                           max_tiles_per_wf=cap) == \
                ref_mb.measure_plan_throughput(ref, instr, plan,
                                               max_tiles_per_wf=cap)


def test_plan_microops_reads_only_blocks():
    """Any object with the plan's ``blocks`` works; the count is the
    covering tiles over the instruction's blocks."""
    class Plan:
        blocks = {"block_m": 100, "block_n": 64, "block_k": 40}
    i = isa.lookup("fp32_4x4x1fp32")     # 4x4x1, 16 blocks
    assert plan_microops(Plan, "fp32_4x4x1fp32") == \
        -(-(25 * 16 * 40) // i.blocks)
    with pytest.raises(isa.UnsupportedInstructionError):
        plan_microops(Plan, "fp32_1x1x1fp32")


def test_reference_program_module_is_not_shared():
    """The port builds its own IR: its Instr is not the reference's."""
    from repro_torch.core import program
    assert program.Instr is not ref_program.Instr
    assert build_listing1("fp32_4x4x1fp32", 2)[0].__class__ is program.Instr


# -- the Listing-1 probe's plain version and Eq. 1 helpers --------------------

@pytest.mark.parametrize("kind", list(probe.KINDS))
@pytest.mark.parametrize("n", [0, 1, 2, 5, 8])
def test_probe_plain_equals_numpy(kind, n):
    """D = C + n A B on the CPU equals numpy's float64 sum exactly, in
    C's dtype and shape; the CPU wrapper runs it and has no stamps."""
    a, b, c = probe.operands(kind, seed=n, device="cpu")
    spec = probe.KINDS[kind]
    assert (a.dtype, b.dtype, c.dtype) == (spec.ab, spec.ab, spec.cd)
    assert a.shape == (spec.m, spec.k) and b.shape == (spec.k, spec.n)
    want = c.double().numpy() + n * (a.double().numpy() @ b.double().numpy())
    assert np.all(want == np.round(want))           # integer-valued
    assert np.abs(want).max() <= 8 + 8 * 4 * spec.k
    got = probe.listing1_plain(a, b, c, n)
    assert got.dtype == spec.cd and got.shape == c.shape
    np.testing.assert_array_equal(got.double().numpy(), want)
    d, stamps = probe.listing1(a, b, c, n)
    assert stamps is None and torch.equal(d, got)


def test_probe_wrapper_rejects_what_no_variant_takes():
    a, b, c = probe.operands("f16", device="cpu")
    with pytest.raises(ValueError, match="no variant takes"):
        probe.listing1(a.float().to(torch.int16), b, c, 2)
    with pytest.raises(ValueError, match="the f16 variant takes"):
        probe.listing1(a[:8], b, c, 2)
    with pytest.raises(ValueError, match="the f16 variant takes"):
        probe.listing1(a, b, c.double(), 2)
    with pytest.raises(ValueError, match=r"outside \[0, 8\]"):
        probe.listing1(a, b, c, 9)
    with pytest.raises(ValueError, match="read on the card"):
        probe.stream_cycles("f16", 2, device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        probe.listing1(a.float().half().requires_grad_(), b, c, 2)


def test_probe_eq1_helpers():
    """Eq. 1 through the port's eq1_latency with t_memtime the overhead
    and t_inst 0, and the least-squares slope, on medians of the form
    T = (N - 1) L + T_probe + x (x the last mma's issue)."""
    L, over, x = 24, 2, 6
    medians = {0: over, 1: over + x}
    medians.update({n: (n - 1) * L + over + x for n in range(2, 6)})
    eq1 = probe.eq1_cycles(medians)
    assert sorted(eq1) == [2, 3, 4, 5]
    for n, v in eq1.items():
        assert v == pytest.approx(L + x / (n - 1))
    assert probe.eq1_cycles(medians, t_inst=x) == {n: L for n in eq1}
    assert probe.least_squares_slope(medians) == pytest.approx(L)
    assert probe.t_total(torch.tensor([100, 137])) == 37
