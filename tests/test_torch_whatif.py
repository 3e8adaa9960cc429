"""The port's what-if sweeps against the reference's (paper Section V-B,
Table VI): ``scale_table``, ``overlay_table``, ``scale_sweep`` and
``grid_sweep`` on every device with a table, and the clear error on
devices without one (the TPUs and the H100); ``workload_grid`` through
the perf pipeline on every device and engine."""

import pytest

from _torch_perf import (ENGINES, GRID, REF_DEVICES, assert_same_report,
                         gemm_text)
from _torch_timing import TABLE_DEVICES, machines, outcome
from repro.arch import overlay as ref_overlay
from repro.core import whatif as ref_whatif
from repro_torch import perf
from repro_torch.arch import Overlay
from repro_torch.core import isa, whatif
from repro_torch.core.machine import get_machine


@pytest.mark.parametrize("name", TABLE_DEVICES)
def test_scale_table_equals_reference(name):
    port, ref = machines(name, mfma_scale=1.5)
    scales = (0.25, 0.5, 1.0, 2.0, 3.7)
    for n in (2, 4):
        assert whatif.scale_table(port, scales, n_mfma=n) == \
            ref_whatif.scale_table(ref, scales, n_mfma=n)
    instrs = list(port.supported_instructions())
    assert whatif.scale_table(port, scales, instrs) == \
        ref_whatif.scale_table(ref, scales, instrs)


@pytest.mark.parametrize("name", TABLE_DEVICES)
def test_overlay_table_equals_reference(name):
    kws = [{}, {"mfma_scale": 2.0}, {"mem_latency_scale": 2.0},
           {"table_patches": {"fp64_16x16x4fp64": 12}, "label": "patched"}]
    port, ref = machines(name)
    got = whatif.overlay_table(port, [Overlay(**kw) for kw in kws])
    want = ref_whatif.overlay_table(ref, [ref_overlay.Overlay(**kw)
                                          for kw in kws])
    assert got == want
    if name == "mi300x":    # its inherited table is not validated
        assert got == {}
    else:
        assert got["fp64_16x16x4fp64"]["patched"] == 12


@pytest.mark.parametrize("name", TABLE_DEVICES)
def test_scale_and_grid_sweeps_equal_reference(name):
    port, ref = machines(name)
    for instr in port.supported_instructions(validated_only=True):
        assert whatif.scale_sweep(port, instr, (0.5, 1, 2, 3)) == \
            ref_whatif.scale_sweep(ref, instr, (0.5, 1, 2, 3))
        axes = dict(mfma_scale=(0.5, 1, 2), mem_latency_scale=(1, 2),
                    clock_scale=(1, 1.25))
        assert whatif.grid_sweep(port, instr, **axes) == \
            ref_whatif.grid_sweep(ref, instr, **axes)


@pytest.mark.parametrize("name", ["h100", "tpu_v5e", "tpu_v5p"])
def test_tableless_devices_raise_clearly(name):
    """scale_table and overlay_table on a device with no MFMA table raise
    UnsupportedInstructionError, as the reference's do, with or without
    instruction names."""
    port, ref = machines(name)
    for fn, ref_fn, args in (
            (whatif.scale_table, ref_whatif.scale_table, ()),
            (whatif.scale_table, ref_whatif.scale_table,
             ((1.0, 2.0), ["fp32_16x16x16fp16"])),
            (whatif.overlay_table, ref_whatif.overlay_table,
             ([Overlay()],)),
            (whatif.scale_sweep, ref_whatif.scale_sweep,
             ("fp32_16x16x16fp16", (1.0,)))):
        ref_args = tuple([ref_overlay.Overlay()] if a == [Overlay()] else a
                         for a in args)
        got = outcome(fn, port, *args)
        assert got[:2] == ("raises", "UnsupportedInstructionError")
        assert got == outcome(ref_fn, ref, *ref_args)
    with pytest.raises(isa.UnsupportedInstructionError,
                       match="no MFMA cycle table"):
        whatif.scale_table(get_machine(name))


def test_workload_grid_is_left_for_the_perf_pipeline():
    """The whole-workload sweep goes through the perf pipeline's twin:
    the port exports what the reference exports, ``workload_grid``
    included, and it prices through ``repro_torch.perf``."""
    assert set(whatif.__all__) == set(ref_whatif.__all__)
    grid = whatif.workload_grid(gemm_text(), "mi300", mfma_scale=(1, 2))
    assert list(grid) == ["baseline", "mfma x2"]
    assert all(isinstance(r, perf.Report) for r in grid.values())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", REF_DEVICES)
def test_workload_grid_equals_reference(name, engine):
    """The same compiled fixture, the same composed grid: the same
    scenarios and Reports (floats to rounding)."""
    got = whatif.workload_grid(gemm_text(), name, engine=engine, **GRID)
    want = ref_whatif.workload_grid(gemm_text(), name, engine=engine,
                                    **GRID)
    assert list(got) == list(want)
    for k in want:
        assert_same_report(got[k], want[k])


def test_workload_grid_on_the_h100_is_roofline_only():
    grid = whatif.workload_grid(gemm_text(), "h100", engine="roofline",
                                bw_scale=(1, 2))
    base, fast = grid.values()
    assert fast.memory_time_s == pytest.approx(base.memory_time_s / 2)
    with pytest.raises(ValueError, match="roofline"):
        whatif.workload_grid(gemm_text(), "h100", mfma_scale=(1, 2))
