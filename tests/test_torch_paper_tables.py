"""The paper's result tables (II-VI) from the port's own timing model,
exactly, and equal to the reference's (twin of
``tests/test_paper_tables.py``).

The simulator is deterministic, so Eq. 1 must return the 'Expected'
column for every N in {2..5}; the paper's hardware samples deviate by
~1.4% (KVM mode), which Section V attributes to measurement noise."""

import pytest

from repro.core import machine as ref_machine
from repro.core import microbench as ref_microbench
from repro.core import whatif as ref_whatif
from repro_torch.core import isa
from repro_torch.core.machine import get_machine
from repro_torch.core.microbench import latency_table, measure_latency
from repro_torch.core.whatif import scale_table

# Tables II & III: MI200, {instr: expected_cycles}
MI200_EXPECTED = {
    "fp64_16x16x4fp64": 32,
    "fp32_4x4x1fp32": 8,
    "fp32_16x16x4fp32": 32,
    "fp32_16x16x16fp16": 32,
    "i32_16x16x16i8": 32,
    "fp64_4x4x4fp64": 16,
    "fp32_4x4x4fp16": 8,
}

# Tables IV & V: MI300 (fp16 16x16x16 halved; i8 16x16x16 removed)
MI300_EXPECTED = {
    "fp64_16x16x4fp64": 32,
    "fp32_4x4x1fp32": 8,
    "fp32_16x16x4fp32": 32,
    "fp32_16x16x16fp16": 16,
    "fp64_4x4x4fp64": 16,
    "fp32_4x4x4fp16": 8,
}


@pytest.mark.parametrize("gpu,expected", [("mi200", MI200_EXPECTED),
                                          ("mi300", MI300_EXPECTED)])
def test_tables_latency(gpu, expected):
    t = latency_table(get_machine(gpu))
    assert set(t) == set(expected)
    for name, exp in expected.items():
        for n in (2, 3, 4, 5):
            assert t[name][n] == exp, (name, n)
    assert t == ref_microbench.latency_table(ref_machine.get_machine(gpu))


def test_mi300_improved_fp16_latency():
    """Section III-A: MI300 halves fp32_16x16x16fp16 (32 -> 16 cycles)."""
    assert isa.mfma_cycles("mi200", "fp32_16x16x16fp16") == 32
    assert isa.mfma_cycles("mi300", "fp32_16x16x16fp16") == 16


def test_i8_removed_on_mi300():
    """Section III-A: i32_16x16x16i8 was removed on MI300."""
    assert isa.mfma_cycles("mi200", "i32_16x16x16i8") == 32
    with pytest.raises(isa.UnsupportedInstructionError):
        isa.mfma_cycles("mi300", "i32_16x16x16i8")
    with pytest.raises(isa.UnsupportedInstructionError):
        measure_latency(get_machine("mi300"), "i32_16x16x16i8", 2)


@pytest.mark.parametrize("gpu", ["mi200", "mi300"])
def test_table_vi_scale2(gpu):
    """Table VI: --mfma-scale=2 doubles every measured latency, as in
    the reference."""
    t = scale_table(get_machine(gpu), scales=(1.0, 2.0))
    for name, per_scale in t.items():
        assert per_scale[2.0] == 2 * per_scale[1.0], name
    assert t == ref_whatif.scale_table(ref_machine.get_machine(gpu),
                                       scales=(1.0, 2.0))


@pytest.mark.parametrize("scale", [0.5, 1.5, 3.0])
def test_scale_generalises(scale):
    m = get_machine("mi300", mfma_scale=scale)
    got = measure_latency(m, "fp64_16x16x4fp64", 4)
    assert got == round(32 * scale)


@pytest.mark.parametrize("gpu", ["mi200", "mi300"])
def test_gpr_idx_instructions_unsupported(gpu):
    """Section VI: s_set_gpr_idx-mode MFMAs are not implemented."""
    for name in ("fp32_32x32x8fp16", "fp32_32x32x1fp32"):
        with pytest.raises(isa.UnsupportedInstructionError):
            isa.mfma_cycles(gpu, name)
        with pytest.raises(isa.UnsupportedInstructionError):
            measure_latency(get_machine(gpu), name, 2)


def test_padding_does_not_change_measurement():
    """Blue-highlighted rows needed i-cache padding on real HW; in the
    deterministic simulator padding must leave Eq. 1's answer unchanged."""
    m = get_machine("mi200")
    for pad in (0, 4, 16):
        assert measure_latency(m, "fp32_16x16x4fp32", 3,
                               padding_nops=pad) == 32
