"""The port's machine facade and cycle-table views against the
reference's: every registered device's machine field for field, its
cycles, supported sets and peaks with and without each scale, the
``isa`` views and their error contracts, and the H100's raising contract
(twin of ``tests/test_arch_registry.py``'s parity and error tests)."""

import dataclasses

import pytest

from _torch_timing import (ALL_DEVICES, REF_DEVICES, SCALES, TABLE_DEVICES,
                           fields_of, machines, outcome)
from repro.arch import registry as ref_registry
from repro.core import isa as ref_isa
from repro.core import machine as ref_machine
from repro_torch.arch import get_device, registry
from repro_torch.core import isa, machine


@pytest.mark.parametrize("name", ALL_DEVICES)
@pytest.mark.parametrize("scale", SCALES)
def test_machine_fields_equal_reference(name, scale):
    port, ref = machines(name, mfma_scale=scale)
    assert fields_of(port) == fields_of(ref)
    assert port.has_mfma_table == ref.has_mfma_table
    assert port.mce_per_cu == ref.mce_per_cu


@pytest.mark.parametrize("name", ALL_DEVICES)
@pytest.mark.parametrize("scale", SCALES)
def test_cycles_and_supported_sets_equal_reference(name, scale):
    """Every instruction of the registry, on every device and scale:
    the machine's cycles (or its error), ``supports``, the supported
    sets, and the ``isa`` views where the reference has the device."""
    port, ref = machines(name, mfma_scale=scale)
    for instr in isa.MFMA_REGISTRY:
        assert outcome(port.mfma_cycles, instr) == \
            outcome(ref.mfma_cycles, instr), instr
        assert port.supports(instr) == ref.supports(instr)
        if name in REF_DEVICES:
            for gpr in (False, True):
                kw = dict(mfma_scale=scale, allow_gpr_idx=gpr)
                assert outcome(isa.mfma_cycles, name, instr, **kw) == \
                    outcome(ref_isa.mfma_cycles, name, instr, **kw)
    for validated_only in (False, True):
        assert outcome(port.supported_instructions,
                       validated_only=validated_only) == \
            outcome(ref.supported_instructions, validated_only=validated_only)
        if name in REF_DEVICES:
            assert list(isa.supported_instructions(
                name, validated_only=validated_only)) == list(
                ref_isa.supported_instructions(
                    name, validated_only=validated_only))


@pytest.mark.parametrize("name", ALL_DEVICES)
@pytest.mark.parametrize("scale", SCALES)
def test_peaks_equal_reference(name, scale):
    port, ref = machines(name, mfma_scale=scale)
    assert outcome(lambda: port.matrix_flops_per_cycle) == \
        outcome(lambda: ref.matrix_flops_per_cycle)
    assert outcome(lambda: port.peak_matrix_tflops) == \
        outcome(lambda: ref.peak_matrix_tflops)
    spec = get_device(name)
    assert outcome(spec.matrix_flops_per_cycle_at, scale) == \
        outcome(machines(name)[1].spec.matrix_flops_per_cycle_at, scale)
    if name in REF_DEVICES:
        assert spec.peak_flops_effective == \
            ref_registry.get_device(name).peak_flops_effective


@pytest.mark.parametrize("gpu", ["mi200", "mi300"])
def test_cycle_table_views_equal_reference(gpu):
    """``isa.MI200_CYCLES`` / ``MI300_CYCLES`` (lazy PEP 562 views) equal
    the reference's views and the registry's raw tables."""
    attr = f"{gpu.upper()}_CYCLES"
    assert getattr(isa, attr) == getattr(ref_isa, attr)
    assert getattr(isa, attr) == getattr(registry, attr)
    with pytest.raises(AttributeError, match="no attribute 'MI250_CYCLES'"):
        isa.MI250_CYCLES


def test_isa_error_contract():
    """Unknown devices raise UnsupportedInstructionError (a KeyError)
    from both views, with the reference's message."""
    for fn, ref_fn, args in (
            (isa.mfma_cycles, ref_isa.mfma_cycles,
             ("no_such_gpu", "fp32_16x16x16fp16")),
            (isa.supported_instructions, ref_isa.supported_instructions,
             ("no_such_gpu",))):
        got = outcome(fn, *args)
        assert got == outcome(ref_fn, *args)
        assert got[:2] == ("raises", "UnsupportedInstructionError")
    with pytest.raises(KeyError):
        isa.mfma_cycles("no_such_gpu", "fp32_16x16x16fp16")


def test_h100_machine_raises_where_the_reference_does():
    """The H100's machine builds with no table (gpu_table None) and
    raises UnsupportedInstructionError from mfma_cycles,
    supported_instructions and matrix_flops_per_cycle, as the
    reference's machine built from the same spec does; its data-sheet
    peak and empty table stay."""
    h = get_device("h100")
    assert dict(h.cycle_table) == {} and h.peak_flops_effective == 989e12
    port, ref = machines("h100")
    assert port.gpu_table is None and not port.has_mfma_table
    for call in (lambda m: m.mfma_cycles("fp32_16x16x16fp16"),
                 lambda m: m.supported_instructions(),
                 lambda m: m.supported_instructions(validated_only=True),
                 lambda m: m.matrix_flops_per_cycle,
                 lambda m: m.peak_matrix_tflops):
        got = outcome(call, port)
        assert got[:2] == ("raises", "UnsupportedInstructionError")
        assert got == outcome(call, ref)
    # the isa view: the spec's own supported set is empty, as a TPU's
    assert list(isa.supported_instructions("h100")) == []
    assert outcome(isa.mfma_cycles, "h100", "fp32_16x16x16fp16")[:2] == \
        ("raises", "UnsupportedInstructionError")


def test_registry_lists_and_module_machines():
    assert machine.list_machines() == ["h100", "mi200", "mi300", "mi300x",
                                       "tpu_v5e", "tpu_v5p"]
    for name in ("MI200", "MI300", "TPU_V5E"):
        assert fields_of(getattr(machine, name)) == \
            fields_of(getattr(ref_machine, name))


@pytest.mark.parametrize("name", TABLE_DEVICES + ("tpu_v5e", "h100"))
def test_as_machine_coerces_name_spec_and_machine(name):
    m = machine.get_machine(name)
    assert machine.as_machine(m) is m
    assert fields_of(machine.as_machine(name)) == fields_of(m)
    assert fields_of(machine.as_machine(get_device(name))) == fields_of(m)
    with pytest.raises(KeyError):
        machine.as_machine("no_such_device")


def test_with_scale_replaces_the_knob():
    m = machine.get_machine("mi300", mfma_scale=2.0).with_scale(0.5)
    ref = ref_machine.get_machine("mi300", mfma_scale=2.0).with_scale(0.5)
    assert m.mfma_scale == 0.5 and fields_of(m) == fields_of(ref)
    assert m.mfma_cycles("fp64_16x16x4fp64") == 16


def test_hand_built_machine_uses_the_isa_view():
    """A MachineModel built by hand (no spec) resolves its cycles through
    the isa view of ``gpu_table``, as the reference's does."""
    kw = dict(name="hb", gpu_table="mi200", clock_mhz=1801.0, mfma_scale=1.5)
    port = machine.MachineModel(**kw)
    ref = ref_machine.MachineModel(**kw)
    for instr in isa.MFMA_REGISTRY:
        assert outcome(port.mfma_cycles, instr) == \
            outcome(ref.mfma_cycles, instr)
    assert list(port.supported_instructions()) == \
        list(ref.supported_instructions())
    assert port.matrix_flops_per_cycle == ref.matrix_flops_per_cycle
    no_table = dataclasses.replace(port, gpu_table=None)
    with pytest.raises(isa.UnsupportedInstructionError,
                       match="no MFMA cycle table"):
        no_table.mfma_cycles("fp32_16x16x16fp16")
