"""The port's what-if overlays and instruction selection against the
reference's: ``Overlay`` compose/describe/apply on every device, grids,
``with_overlay`` on registered and hand-tweaked machines (twin of
``tests/test_arch_registry.py``'s overlay tests), ``best_mfma`` and
``throughput_ranking`` on every device."""

import dataclasses

import pytest

from _torch_timing import (ALL_DEVICES, SCALES, TABLE_DEVICES, fields_of,
                           machines, outcome, ref_spec_of)
from repro.arch import overlay as ref_overlay
from repro.arch import select as ref_select
from repro.core import machine as ref_machine
from repro_torch.arch import (HLO_DTYPE_TO_IN, IDENTITY, Overlay, best_mfma,
                              best_mfma_for_hlo, get_device, overlay_grid,
                              throughput_ranking)
from repro_torch.core import isa
from repro_torch.core.machine import MachineModel, get_machine

#: (port overlay, reference overlay) pairs: every knob alone, together,
#: and table patches (one the device lacks adds it).
OVERLAY_KW = [
    {},
    {"mfma_scale": 2.0},
    {"mfma_scale": 0.5, "clock_scale": 1.2},
    {"mem_latency_scale": 2.0},
    {"bw_scale": 1.5},
    {"mfma_scale": 3.7, "clock_scale": 0.8, "mem_latency_scale": 1.3,
     "bw_scale": 0.5},
    {"table_patches": {"fp32_16x16x16fp16": 8}},
    {"table_patches": {"fp32_16x16x32fp8": 8, "fp64_16x16x4fp64": 40},
     "mfma_scale": 1.5, "label": "new fp8"},
]


def _spec_view(spec):
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("kw", OVERLAY_KW)
@pytest.mark.parametrize("name", ALL_DEVICES)
def test_overlay_apply_equals_reference(kw, name):
    port_spec = get_device(name)
    got = Overlay(**kw).apply(port_spec)
    want = ref_overlay.Overlay(**kw).apply(ref_spec_of(port_spec))
    assert _spec_view(got) == _spec_view(want)
    assert Overlay(**kw).describe() == ref_overlay.Overlay(**kw).describe()
    assert Overlay(**kw).is_identity == ref_overlay.Overlay(**kw).is_identity


@pytest.mark.parametrize("kw", OVERLAY_KW)
@pytest.mark.parametrize("name", ALL_DEVICES)
def test_with_overlay_equals_reference(kw, name):
    """The overlaid machine's fields, and its cycles for every
    instruction (or the same error)."""
    port, ref = machines(name, mfma_scale=1.5)
    got = port.with_overlay(Overlay(**kw))
    want = ref.with_overlay(ref_overlay.Overlay(**kw))
    assert fields_of(got) == fields_of(want)
    assert _spec_view(got.spec) == _spec_view(want.spec)
    for instr in isa.MFMA_REGISTRY:
        assert outcome(got.mfma_cycles, instr) == \
            outcome(want.mfma_cycles, instr)
    assert outcome(lambda: got.matrix_flops_per_cycle) == \
        outcome(lambda: want.matrix_flops_per_cycle)


def test_overlay_compose_multiplies():
    a, b = Overlay(mfma_scale=2.0, label="x"), Overlay(
        mfma_scale=1.5, clock_scale=1.2, table_patches={"fp64_4x4x4fp64": 4})
    ov = a.compose(b)
    assert ov.mfma_scale == pytest.approx(3.0)
    assert ov.clock_scale == pytest.approx(1.2)
    want = ref_overlay.Overlay(mfma_scale=2.0, label="x").compose(
        ref_overlay.Overlay(mfma_scale=1.5, clock_scale=1.2,
                            table_patches={"fp64_4x4x4fp64": 4}))
    assert dataclasses.asdict(ov) == dataclasses.asdict(want)
    assert IDENTITY.is_identity and IDENTITY.describe() == "baseline"
    assert IDENTITY.apply(get_device("mi200")) is get_device("mi200")


@pytest.mark.parametrize("gpu", ["mi200", "mi300"])
@pytest.mark.parametrize("scale", SCALES)
def test_overlay_rounds_as_scale_cycles(gpu, scale):
    """The gem5 rule max(1, round(base * scale)) agrees across the isa
    view, the machine knob and a baked-in overlay."""
    machine = get_machine(gpu, mfma_scale=scale)
    overlaid = get_machine(gpu).with_overlay(Overlay(mfma_scale=scale))
    baked = Overlay(mfma_scale=scale).apply(get_device(gpu))
    for name, entry in get_device(gpu).cycle_table.items():
        if isa.lookup(name).gpr_idx_mode:
            continue
        expect = max(1, int(round(entry.cycles * scale)))
        assert isa.mfma_cycles(gpu, name, mfma_scale=scale) == expect
        assert machine.mfma_cycles(name) == expect
        assert overlaid.mfma_cycles(name) == expect
        assert baked.mfma_cycles(name) == expect


def test_overlay_table_patch():
    m = get_machine("mi300").with_overlay(
        Overlay(table_patches={"fp32_16x16x16fp16": 8}))
    assert m.mfma_cycles("fp32_16x16x16fp16") == 8
    assert m.mfma_cycles("fp64_16x16x4fp64") == 32
    assert m.spec.cycle_table["fp64_16x16x4fp64"].validated
    assert not m.spec.cycle_table["fp32_16x16x16fp16"].validated


def test_overlay_patch_adds_missing_instruction():
    assert "fp32_16x16x32fp8" not in get_device("mi200").cycle_table
    m = get_machine("mi200").with_overlay(
        Overlay(table_patches={"fp32_16x16x32fp8": 8}))
    assert m.mfma_cycles("fp32_16x16x32fp8") == 8
    assert not m.spec.cycle_table["fp32_16x16x32fp8"].validated


def test_overlay_mem_latency_scale():
    m = get_machine("mi200").with_overlay(Overlay(mem_latency_scale=2.0))
    assert m.l1d_latency == 280 and m.lds_latency == 130
    assert m.valu_latency == get_machine("mi200").valu_latency


def test_overlay_preserves_machine_field_tweaks():
    """replace()-tweaked machine fields survive an overlay and feed the
    peak formula, as in the reference."""
    m = dataclasses.replace(get_machine("mi200"), cu_count=10)
    ref = dataclasses.replace(ref_machine.get_machine("mi200"), cu_count=10)
    out = m.with_overlay(Overlay(clock_scale=2.0))
    assert out.cu_count == 10
    assert out.clock_mhz == pytest.approx(2 * 1801.0)
    assert out.matrix_flops_per_cycle == pytest.approx(
        get_machine("mi200").matrix_flops_per_cycle * 10 / 60)
    assert fields_of(out) == fields_of(
        ref.with_overlay(ref_overlay.Overlay(clock_scale=2.0)))


def test_specless_machine_rejects_non_mfma_overlay():
    hb = MachineModel(name="hb", gpu_table="mi200", clock_mhz=1801.0)
    assert hb.with_overlay(Overlay(mfma_scale=2.0)).mfma_scale == 2.0
    with pytest.raises(ValueError, match="no backing DeviceSpec"):
        hb.with_overlay(Overlay(clock_scale=2.0))


def test_overlay_grid_cartesian():
    grid = overlay_grid(mfma_scale=(0.5, 1, 2), clock_scale=(1, 1.2))
    assert len(grid) == 6
    assert [dataclasses.asdict(o) for o in grid] == [
        dataclasses.asdict(o) for o in ref_overlay.overlay_grid(
            mfma_scale=(0.5, 1, 2), clock_scale=(1, 1.2))]
    with pytest.raises(TypeError, match="unknown overlay axis"):
        overlay_grid(bogus_scale=(1, 2))
    with pytest.raises(TypeError):
        overlay_grid(table_patches=({},))


# -- instruction selection ---------------------------------------------------

@pytest.mark.parametrize("name", ALL_DEVICES)
@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
def test_selection_equals_reference(name, scale):
    """best_mfma for every operand dtype, best_mfma_for_hlo for every
    HLO type (and an unknown one), and the ranking, on every device."""
    spec = get_device(name)
    ref = ref_spec_of(spec)
    for dt in ("fp64", "fp32", "fp16", "bf16", "i8", "fp8", "none"):
        assert best_mfma(spec, dt, mfma_scale=scale) == \
            ref_select.best_mfma(ref, dt, mfma_scale=scale)
    for hlo in list(HLO_DTYPE_TO_IN) + ["pred"]:
        assert best_mfma_for_hlo(spec, hlo, mfma_scale=scale) == \
            ref_select.best_mfma_for_hlo(ref, hlo, mfma_scale=scale)
    assert throughput_ranking(spec, mfma_scale=scale) == \
        ref_select.throughput_ranking(ref, mfma_scale=scale)
    assert HLO_DTYPE_TO_IN == ref_select.HLO_DTYPE_TO_IN


def test_selection_on_tableless_devices():
    """The H100 and the TPUs have no MFMA table: nothing to pick."""
    for name in ("h100", "tpu_v5e", "tpu_v5p"):
        assert best_mfma(get_device(name), "bf16") is None
        assert throughput_ranking(get_device(name)) == []
    for name in TABLE_DEVICES:
        assert best_mfma(get_device(name), "bf16") is not None
