"""The port's device-capability layer: the ``DeviceSpec`` schema equals
the reference's field for field (names, types and defaults), and the
catalog's one device, the H100, holds NVIDIA's data-sheet figures."""

import dataclasses

import pytest

from repro.arch import spec as ref_spec
from repro_torch.arch import (CycleEntry, DeviceSpec, Interconnect,
                              MemoryHierarchy, UnknownDeviceError,
                              get_device, list_devices, register_device)
from repro_torch.arch import spec


def _default(f):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    if dataclasses.is_dataclass(f.default):    # compare by value: the
        return dataclasses.asdict(f.default)   # classes are the packages'
    return f.default


def _fields(cls):
    return [(f.name, str(f.type), _default(f)) for f in
            dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["DeviceSpec", "MemoryHierarchy",
                                  "Interconnect", "CycleEntry"])
def test_schema_equals_reference(name):
    assert _fields(getattr(spec, name)) == _fields(getattr(ref_spec, name))


def test_default_spec_equals_reference():
    got = dataclasses.asdict(DeviceSpec(name="x"))
    want = dataclasses.asdict(ref_spec.DeviceSpec(name="x"))
    assert got == want


def test_helpers_equal_reference():
    for cycles, scale in [(32, 1.0), (32, 1.5), (1, 0.1), (64, 0.5)]:
        assert spec.scale_cycles(cycles, scale) == \
            ref_spec.scale_cycles(cycles, scale)
    kw = dict(mxu_count=0, mxu_dim=128, cu_count=104, mce_per_cu=4,
              canonical_cycles=16)
    assert spec.matrix_peak_flops_per_cycle(**kw) == \
        ref_spec.matrix_peak_flops_per_cycle(**kw)
    kw.update(mxu_count=8)
    assert spec.matrix_peak_flops_per_cycle(**kw) == \
        ref_spec.matrix_peak_flops_per_cycle(**kw)


def test_h100_figures():
    h = get_device("H100")
    assert list(list_devices()) == ["h100"]
    assert (h.cu_count, h.simd_per_cu, h.mce_per_simd) == (132, 4, 1)
    assert h.wavefront_size == 32
    assert h.memory.hbm_bw == 3.35e12
    assert h.peak_flops == 989e12 and h.peak_flops_effective == 989e12
    assert (h.interconnect.links, h.interconnect.link_bw) == (18, 50e9)
    assert h.vmem_bytes == 232448
    # 989 TFLOP/s = 132 SMs x 4 tensor cores x 1024 flop/clock x 1.83 GHz
    assert h.cu_count * h.mce_per_cu * 1024 * h.clock_mhz * 1e6 == \
        pytest.approx(h.peak_flops, rel=1e-3)
    assert dict(h.cycle_table) == {} and not h.has_cycle_table


def test_h100_has_no_mfma_timing():
    from repro_torch.core.isa import UnsupportedInstructionError
    h = get_device("h100")
    with pytest.raises(UnsupportedInstructionError, match="no MFMA cycle"):
        h.mfma_cycles("fp32_16x16x16fp16")
    with pytest.raises(UnsupportedInstructionError, match="gpr_idx"):
        h.mfma_cycles("fp32_32x32x8fp16")
    assert not h.supports("fp32_16x16x16fp16")
    assert list(h.supported_instructions()) == []


def test_registry_contract():
    with pytest.raises(UnknownDeviceError, match="registered: \\['h100'\\]"):
        get_device("mi200")
    assert issubclass(UnknownDeviceError, KeyError)
    with pytest.raises(ValueError, match="already registered"):
        register_device(get_device("h100"))
    assert register_device(get_device("h100"), replace=True) is \
        get_device("h100")


def test_derive_marks_inherited_entries_unvalidated():
    base = DeviceSpec(name="base", cycle_table={
        "fp32_16x16x4fp32": CycleEntry(32, True)})
    d = base.derive("d", revalidate=False, hbm_bw=1e12, links=2,
                    cu_count=8)
    assert d.cycle_table["fp32_16x16x4fp32"] == CycleEntry(32, False)
    assert d.memory == MemoryHierarchy(hbm_bw=1e12)
    assert d.interconnect == Interconnect(links=2)
    assert d.cu_count == 8 and d.mfma_cycles("fp32_16x16x4fp32",
                                             mfma_scale=1.5) == 48
