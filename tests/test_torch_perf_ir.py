"""The port's HLO -> KernelGraph parser against the reference's on the
same texts: the reference tests' compiled fixtures, the hand-written
nested-while modules in every trip-count variant, the collective module;
static dots, collective stats, the upcast estimate, the IR's types."""

import jax
import jax.numpy as jnp
import pytest

from _torch_perf import gemm_text, hand_texts, mlp_text, plain
from _torch_timing import outcome
from repro.perf import hlo_ir as ref_ir
from repro_torch.perf import hlo_ir

TEXTS = ("gemm", "mlp", *hand_texts())


def _text(name):
    return {"gemm": gemm_text, "mlp": mlp_text}.get(
        name, lambda: hand_texts()[name])()


@pytest.mark.parametrize("tpu_correct", [True, False])
@pytest.mark.parametrize("name", TEXTS)
def test_parse_module_equals_reference(name, tpu_correct):
    """Field for field: typed ops with their counts and bytes, flops,
    bytes, wire bytes, flash bytes, the per-opcode table, key, source."""
    txt = _text(name)
    got = hlo_ir.parse_module(txt, tpu_correct=tpu_correct)
    want = ref_ir.parse_module(txt, tpu_correct=tpu_correct)
    assert plain(got) == plain(want)
    assert got.dot_pairs() == [(op, op.count) for op in got.dots]
    assert plain(got.collectives) == plain(want.collectives)
    assert [op.label for op in got.ops] == [op.label for op in want.ops]


def test_loop_counts_and_collectives_as_the_reference_pins_them():
    """The reference tests' own readings hold for the port's parse."""
    texts = hand_texts()
    dot = 2 * 16 ** 3
    for name, trips in (("whiles_known", 15), ("whiles_condition", 15),
                        ("whiles_unknown_inner", 5),
                        ("whiles_known_outer", 6)):
        g = hlo_ir.parse_module(texts[name])
        assert g.dot_pairs()[0][1] == pytest.approx(trips)
        assert g.flops == pytest.approx(trips * dot)
    g = hlo_ir.parse_module(texts["collectives"])
    assert g.collective_wire > 0 and "all-gather" in g.collectives


@pytest.mark.parametrize("name", TEXTS)
def test_static_dots_and_collectives_equal_reference(name):
    txt = _text(name)
    assert plain(hlo_ir.parse_static_dots(txt)) == \
        plain(ref_ir.parse_static_dots(txt))
    assert hlo_ir.parse_collectives_static(txt) == \
        ref_ir.parse_collectives_static(txt)
    assert hlo_ir.collective_wire_bytes(txt) == \
        ref_ir.collective_wire_bytes(txt)
    assert hlo_ir.cpu_upcast_bytes(txt) == ref_ir.cpu_upcast_bytes(txt)
    assert hlo_ir.graph_key(txt) == ref_ir.graph_key(txt)


def test_stablehlo_dots_equal_reference():
    """A lowered (not compiled) StableHLO module keeps bf16 operands."""
    a = jax.ShapeDtypeStruct((256, 512), jnp.bfloat16)
    b = jax.ShapeDtypeStruct((512, 128), jnp.bfloat16)
    txt = jax.jit(lambda x, y: x @ y).lower(a, b).as_text()
    got = hlo_ir.parse_static_dots(txt)
    assert plain(got) == plain(ref_ir.parse_static_dots(txt))
    (d,) = got
    assert (d.m, d.n, d.k, d.batch, d.dtype) == (256, 128, 512, 1, "bf16")


def test_cpu_upcast_bytes_equals_reference():
    """``tests/test_perf_ir.py``'s hoisted convert, and inside a fusion."""
    dims = "8388608,4"
    txt = (f"ENTRY %e (p: bf16[{dims}]) -> f32[{dims}] {{\n"
           f"  %p = bf16[{dims}] parameter(0)\n"
           f"  ROOT %c = f32[{dims}] convert(%p)\n"
           "}\n")
    fused = txt.replace("ENTRY %e", "%fused_computation.1")
    for t in (txt, fused):
        assert hlo_ir.cpu_upcast_bytes(t) == ref_ir.cpu_upcast_bytes(t)
    assert hlo_ir.cpu_upcast_bytes(txt) == 8388608 * 4 * 4


def test_errors_equal_reference():
    for txt in ("HloModule empty\n", "", "ENTRY"):
        got = outcome(hlo_ir.parse_module, txt)
        assert got == outcome(ref_ir.parse_module, txt)
    assert got[:2] == ("raises", "ValueError")


def test_ir_types_equal_reference():
    """The byte table, a dot and a collective op, totals-only graphs."""
    assert hlo_ir.BYTES_PER_ELEM == ref_ir.BYTES_PER_ELEM
    assert hlo_ir.FREE_OPS == ref_ir.FREE_OPS
    kws = [dict(kind="dot", opcode="dot", dtype="bf16", batch=3, m=5, n=7,
                k=11, count=4.0, bytes=96.0),
           dict(kind="collective", opcode="all-reduce", dtype="f32",
                bytes=64.0, wire_bytes=112.0, group=8, count=2.0),
           dict(kind="memory", opcode="fusion", bytes=1e6)]
    for kw in kws:
        got, want = hlo_ir.KernelOp(**kw), ref_ir.KernelOp(**kw)
        assert (got.label, got.macs, got.flops, got.in_dtype) == \
            (want.label, want.macs, want.flops, want.in_dtype)
        assert plain(got.as_dot()) == plain(want.as_dot())
    got = hlo_ir.KernelGraph(ops=[hlo_ir.KernelOp(**kw) for kw in kws])
    want = ref_ir.KernelGraph(ops=[ref_ir.KernelOp(**kw) for kw in kws])
    assert got.collectives == want.collectives
    totals = dict(flops=1e12, bytes_accessed=2e9, collective_wire=3e8,
                  flash_block_bytes=1e8, key="cell")
    assert plain(hlo_ir.KernelGraph.from_totals(**totals)) == \
        plain(ref_ir.KernelGraph.from_totals(**totals))
