"""The deprecated shims over the perf pipeline against the reference's:
``hlo_bridge``'s parse/predict surface and ``hlo_analysis.analyze`` on
the same texts, their one-shot warnings, and the reference's
``test_new_devices_predict`` on the port's devices."""

import warnings

import jax
import jax.numpy as jnp
import pytest

from _torch_perf import REF_DEVICES, gemm_text, hand_texts, mlp_text, plain
from repro.core import hlo_analysis as ref_ha
from repro.core import hlo_bridge as ref_hb
from repro.core.machine import get_machine as ref_get_machine
from repro_torch.arch import get_device
from repro_torch.core import hlo_analysis as ha
from repro_torch.core import hlo_bridge as hb
from repro_torch.core.machine import as_machine, get_machine

pytestmark = [
    pytest.mark.filterwarnings(
        "ignore:repro.core.hlo_bridge:DeprecationWarning"),
    pytest.mark.filterwarnings(
        "ignore:repro.core.hlo_analysis:DeprecationWarning"),
    pytest.mark.filterwarnings(
        "ignore:repro_torch.core.hlo_bridge:DeprecationWarning"),
    pytest.mark.filterwarnings(
        "ignore:repro_torch.core.hlo_analysis:DeprecationWarning")]


def _texts():
    a = jax.ShapeDtypeStruct((4, 64, 32), jnp.float32)
    b = jax.ShapeDtypeStruct((4, 32, 16), jnp.float32)
    lowered = jax.jit(lambda x, y: jnp.einsum("bmk,bkn->bmn", x, y)).lower(
        a, b).as_text()
    return {"gemm": gemm_text(), "mlp": mlp_text(),
            "stablehlo_batched": lowered, **hand_texts()}


@pytest.mark.parametrize("device", REF_DEVICES)
def test_bridge_equals_reference(device):
    """parse_dots, parse_collectives, collective_bytes_total, predict
    (with and without a loop-aware FLOP count, at two scales) and
    predict_dots with explicit counts."""
    for name, txt in _texts().items():
        assert plain(hb.parse_dots(txt)) == plain(ref_hb.parse_dots(txt))
        assert hb.parse_collectives(txt) == ref_hb.parse_collectives(txt)
        assert hb.collective_bytes_total(txt) == \
            ref_hb.collective_bytes_total(txt)
        for scale in (1.0, 2.0):
            port = get_machine(device, mfma_scale=scale)
            ref = ref_get_machine(device, mfma_scale=scale)
            for cost in (None, 7 * 2.0 * 16 ** 3):
                assert plain(hb.predict(port, txt, cost_flops=cost)) == \
                    plain(ref_hb.predict(ref, txt, cost_flops=cost)), name
            pairs = [(d, 3.0) for d in hb.parse_dots(txt)]
            ref_pairs = [(d, 3.0) for d in ref_hb.parse_dots(txt)]
            assert plain(hb.predict_dots(port, pairs)) == \
                plain(ref_hb.predict_dots(ref, ref_pairs))


@pytest.mark.parametrize("tpu_correct", [True, False])
def test_analyze_equals_reference(tpu_correct):
    for txt in _texts().values():
        if "ENTRY" not in txt:
            continue
        assert plain(ha.analyze(txt, tpu_correct=tpu_correct)) == \
            plain(ref_ha.analyze(txt, tpu_correct=tpu_correct))
        assert ha.analyze(txt).collective_wire_bytes == \
            ref_ha.analyze(txt).collective_wire_bytes


def test_deprecations_are_one_shot(monkeypatch):
    monkeypatch.setattr(hb, "_WARNED", False)
    monkeypatch.setattr(ha, "_WARNED", False)
    txt = gemm_text()
    with pytest.warns(DeprecationWarning, match="repro_torch.perf.predict"):
        hb.predict(get_machine("mi300"), txt)
    with pytest.warns(DeprecationWarning, match="parse_cached"):
        ha.analyze(txt)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        hb.predict(get_machine("mi300"), txt)
        ha.analyze(txt)
        hb.predict_dots(get_machine("mi300"),
                        [(d, 1.0) for d in hb.parse_dots(txt)])


def test_new_devices_predict():
    """``tests/test_arch_registry.py``'s ``test_new_devices_predict`` on
    the port's devices, plus the H100, which raises."""
    dot = hb.DotOp(in_dtype="bf16", batch=1, m=256, n=256, k=256)
    t = {}
    for dev in ("mi300", "mi300x", "tpu_v5e", "tpu_v5p"):
        pred = hb.predict_dots(get_machine(dev), [(dot, 1.0)])
        assert pred.total_mfma > 0
        assert pred.mce_time_s > 0
        t[dev] = pred.mce_time_s
        ref_dot = ref_hb.DotOp(in_dtype="bf16", batch=1, m=256, n=256,
                               k=256)
        assert plain(pred) == plain(ref_hb.predict_dots(
            ref_get_machine(dev), [(ref_dot, 1.0)]))
    assert t["mi300x"] < t["mi300"]
    assert t["tpu_v5p"] < t["tpu_v5e"]
    assert hb.best_instr(get_machine("mi300x"), "bf16") is not None
    assert hb.best_instr(as_machine(get_device("tpu_v5p")), "bf16") is None
    assert hb.best_instr(get_machine("h100"), "bf16") is None
    with pytest.raises(ValueError, match="roofline"):
        hb.predict_dots(get_machine("h100"), [(dot, 1.0)])
