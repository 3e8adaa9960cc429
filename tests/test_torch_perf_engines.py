"""The port's cost engines against the reference's on the same HLO text:
every engine on the reference's five devices, without and with overlay
scenarios (``overlay_grid`` included), gives a ``Report`` equal field
for field (floats to rounding, rel 1e-12); sweeps, custom engines and
the degraded paths likewise.  On the H100 the roofline prices and plans
the executed tile, and the MFMA and scoreboard engines raise."""

import importlib

import pytest

from _torch_perf import (ENGINES, GRID, OVERLAYS, REF_DEVICES,
                         assert_close, assert_same_report, gemm_text,
                         mlp_text, overlay_pair, plain)
from _torch_timing import outcome
from repro import perf as ref_perf
from repro.arch import get_device as ref_get_device
from repro.arch import overlay_grid as ref_overlay_grid
from repro.core.machine import MachineModel as RefMachineModel
from repro.core.machine import get_machine as ref_get_machine
from repro.perf import engines as ref_engines
from repro.perf import hlo_ir as ref_ir
from repro_torch import perf
from repro_torch.arch import get_device, overlay_grid
from repro_torch.core.machine import MachineModel, get_machine
from repro_torch.perf import engines, hlo_ir

TEXTS = {"gemm": gemm_text, "mlp": mlp_text}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("device", REF_DEVICES)
def test_reports_equal_reference(engine, device):
    """Baseline, the reference tests' three overlays and a composed
    (mfma_scale x clock_scale) grid, on both compiled fixtures."""
    pairs = [overlay_pair(kw) for kw in OVERLAYS]
    for name, text in TEXTS.items():
        txt = text()
        got = perf.predict(txt, device=device, engine=engine,
                           workload_name=name)
        want = ref_perf.predict(txt, device=device, engine=engine,
                                workload_name=name)
        assert_same_report(got, want)
        got = perf.predict(txt, device=device, engine=engine,
                           overlays=[p for p, _ in pairs])
        want = ref_perf.predict(txt, device=device, engine=engine,
                                overlays=[r for _, r in pairs])
        assert_close(plain(got), plain(want))
        got = perf.predict(txt, device=device, engine=engine,
                           overlays=overlay_grid(**GRID))
        want = ref_perf.predict(txt, device=device, engine=engine,
                                overlays=ref_overlay_grid(**GRID))
        assert len(got) == 6
        assert_close(plain(got), plain(want))


@pytest.mark.parametrize("device", REF_DEVICES)
def test_machines_with_overlays_equal_reference(device):
    """A machine built with an overlay, passed as the device."""
    for kw in OVERLAYS[1:]:
        port_ov, ref_ov = overlay_pair(kw)
        for engine in ENGINES:
            got = perf.predict(gemm_text(), engine=engine,
                               device=get_machine(device, overlay=port_ov))
            want = ref_perf.predict(
                gemm_text(), engine=engine,
                device=ref_get_machine(device, overlay=ref_ov))
            assert_same_report(got, want)


def test_sweep_equals_reference():
    """The cartesian sweep: 2 workloads x 5 devices x 3 engines x 2
    scenarios, engine instances shared across cells."""
    ovs = [overlay_pair(kw) for kw in OVERLAYS[:2]]
    work = {name: text() for name, text in TEXTS.items()}
    got = perf.sweep(work, devices=REF_DEVICES, engines=ENGINES,
                     overlays=[p for p, _ in ovs])
    want = ref_perf.sweep(work, devices=REF_DEVICES, engines=ENGINES,
                          overlays=[r for _, r in ovs])
    assert len(got) == 2 * 5 * 3 * 2
    assert_close(plain(got), plain(want))
    assert perf.format_reports(got) == ref_perf.format_reports(want)


@pytest.mark.parametrize("device", REF_DEVICES)
def test_totals_graph_roofline_equals_reference(device):
    """A dry-run record's totals (collectives and flash bytes too), both
    roofline variants, every overlay."""
    totals = dict(flops=1.2e12, bytes_accessed=3.4e9, collective_wire=5.6e8,
                  flash_block_bytes=1.1e8, key="cell")
    for adjusted in (True, False):
        for kw in OVERLAYS:
            port_ov, ref_ov = overlay_pair(kw)
            got = engines.RooflineEngine(kernel_adjusted=adjusted).estimate(
                hlo_ir.KernelGraph.from_totals(**totals),
                get_machine(device, overlay=port_ov))
            want = ref_engines.RooflineEngine(
                kernel_adjusted=adjusted).estimate(
                ref_ir.KernelGraph.from_totals(**totals),
                ref_get_machine(device, overlay=ref_ov))
            assert_same_report(got, want)


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32", "f64", "s8",
                                   "f8e4m3fn", "c64"])
def test_instruction_selection_equals_reference(dtype):
    d = hlo_ir.DotOp(in_dtype=dtype, batch=2, m=100, n=300, k=70)
    for device in REF_DEVICES:
        for scale in (1.0, 2.0):
            instr = engines.best_instr(get_machine(device, mfma_scale=scale),
                                       dtype)
            assert instr == ref_engines.best_instr(
                ref_get_machine(device, mfma_scale=scale), dtype)
            if instr is not None:
                assert engines.mfma_count(d, instr) == \
                    ref_engines.mfma_count(d, instr)


def test_degraded_paths_equal_reference():
    """The reference tests' corner cases, run in both packages: an
    integer dot, a device too small for any tile, a budget failure that
    must not be masked, a dtype that falls back, a totals-only graph."""
    s8 = dict(kind="dot", opcode="dot", dtype="s8", batch=1, m=128, n=128,
              k=128)
    got = perf.predict(hlo_ir.KernelGraph(
        ops=[hlo_ir.KernelOp(**s8)], flops=2.0 * 128 ** 3, key="s8"),
        device="mi200", engine="scoreboard")
    want = ref_perf.predict(ref_ir.KernelGraph(
        ops=[ref_ir.KernelOp(**s8)], flops=2.0 * 128 ** 3, key="s8"),
        device="mi200", engine="scoreboard")
    assert_same_report(got, want)
    assert got.plan["dtype"] == "s8"
    for kb in (300, 450):
        name = f"mi200_vmem_{kb}k"
        port_m = MachineModel.from_spec(get_device("mi200").derive(
            name, vmem_bytes=kb << 10))
        ref_m = RefMachineModel.from_spec(ref_get_device("mi200").derive(
            name, vmem_bytes=kb << 10))
        for engine in ENGINES:
            assert_same_report(
                perf.predict(gemm_text(), device=port_m, engine=engine),
                ref_perf.predict(gemm_text(), device=ref_m, engine=engine))
        for dtype in ("f32", "bf16", "c64"):
            dot = dict(kind="dot", opcode="dot", dtype=dtype, batch=1,
                       m=256, n=256, k=256)
            got = outcome(engines.plan_for_dot, port_m,
                          hlo_ir.KernelOp(**dot))
            want = outcome(ref_engines.plan_for_dot, ref_m,
                           ref_ir.KernelOp(**dot))
            assert plain(got) == plain(want)
    totals = dict(flops=1e12, bytes_accessed=1e9, collective_wire=0.0)
    assert_same_report(
        perf.predict(hlo_ir.KernelGraph.from_totals(**totals),
                     device="mi300", engine="roofline"),
        ref_perf.predict(ref_ir.KernelGraph.from_totals(**totals),
                         device="mi300", engine="roofline"))


def test_custom_engine_plugs_in():
    class Intensity:
        name = "intensity"

        def estimate(self, graph, machine):
            return perf.Report(engine=self.name, device="any",
                               total_time_s=graph.flops / max(
                                   graph.bytes_accessed, 1), bound="compute")

    perf.register_engine("intensity", Intensity)
    rep = perf.predict(gemm_text(), device="mi300", engine="intensity")
    assert rep.engine == "intensity" and rep.total_time_s > 0
    assert "intensity" in perf.list_engines()
    with pytest.raises(KeyError, match="unknown engine"):
        perf.get_engine("no-such-engine")


def test_h100_roofline_prices_and_plans_the_executed_tile():
    """Only the roofline prices the H100, from its spec; the plan is the
    tile ``mfma_gemm`` runs: XLA:CPU compiles the fixture's dot in f32,
    which runs on the CUDA cores' 64 x 64 blocks; a bf16 dot with M > 64
    and K, N multiples of 8 on the ``wgmma`` tile."""
    g = importlib.import_module("repro_torch.kernels.mfma_gemm")
    graph = perf.parse_cached(gemm_text())
    assert [op.dtype for op in graph.dots] == ["f32"]
    rep = perf.predict(graph, device="h100", engine="roofline")
    spec = get_device("h100")
    assert rep.compute_time_s == graph.flops / spec.peak_flops
    assert rep.memory_time_s == graph.bytes_accessed / spec.memory.hbm_bw
    assert _tile(rep.plan) == (g.TILE, g.TILE, g.TILE_K) == (64, 64, 32)
    assert rep.plan["device"] == "h100" and rep.plan["align"] == 64
    dot = hlo_ir.KernelOp(kind="dot", opcode="dot", dtype="bf16", batch=1,
                          m=256, n=256, k=256)
    rep = perf.predict(hlo_ir.KernelGraph(ops=[dot], flops=dot.flops),
                       device="h100", engine="roofline")
    assert _tile(rep.plan) == (g.WGMMA_ROWS, g.WGMMA_COLUMNS, g.BLOCK_K) \
        == (128, 256, 64)


def _tile(plan):
    return plan["block_m"], plan["block_n"], plan["block_k"]


@pytest.mark.parametrize("engine", ["mfma", "scoreboard"])
def test_h100_matrix_engines_raise_naming_the_roofline(engine):
    """The reference would price a device with neither a cycle table nor
    MXUs at 0 s; the port raises, with or without overlays."""
    for kw in ({}, {"mfma_scale": 2.0}):
        with pytest.raises(ValueError, match="engine='roofline'"):
            perf.predict(gemm_text(), device="h100", engine=engine,
                         overlays=overlay_pair(kw)[0])
    with pytest.raises(ValueError, match="neither an MFMA cycle table"):
        perf.sweep([gemm_text()], devices=["mi300", "h100"],
                   engines=[engine])
    with pytest.raises(ValueError, match="roofline"):
        engines.cost_dot_pairs(get_machine("h100"), [])
