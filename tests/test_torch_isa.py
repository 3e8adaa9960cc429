"""The port's MFMA instruction registry against the reference's: every
instruction field for field, the derived shapes and flop counts, and
``lookup``'s error contract."""

import dataclasses

import pytest

from repro.core import isa as ref_isa
from repro_torch.core import isa


def test_registry_has_the_reference_instructions_in_order():
    assert list(isa.MFMA_REGISTRY) == list(ref_isa.MFMA_REGISTRY)
    assert len(isa.MFMA_REGISTRY) == 17


@pytest.mark.parametrize("name", list(ref_isa.MFMA_REGISTRY))
def test_instruction_equals_reference(name):
    got, want = isa.lookup(name), ref_isa.lookup(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.a_shape, got.b_shape, got.d_shape) == \
        (want.a_shape, want.b_shape, want.d_shape)
    assert got.macs == want.macs and got.flops == want.flops
    assert isa.flops_per_instr(name) == ref_isa.flops_per_instr(name)


def test_validated_set_and_gpr_idx_flags():
    gpr = sorted(n for n, i in isa.MFMA_REGISTRY.items() if i.gpr_idx_mode)
    assert gpr == ["fp32_32x32x1fp32", "fp32_32x32x8fp16"]
    kinds = {i.in_dtype for i in isa.MFMA_REGISTRY.values()}
    assert kinds == {"fp64", "fp32", "fp16", "bf16", "i8", "fp8"}


def test_lookup_error_contract():
    with pytest.raises(isa.UnsupportedInstructionError,
                       match="unknown MFMA instruction 'fp32_1x1x1fp32'"):
        isa.lookup("fp32_1x1x1fp32")
    # a KeyError, as the reference's, so `except KeyError` callers work
    assert issubclass(isa.UnsupportedInstructionError, KeyError)
