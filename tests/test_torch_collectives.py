"""int8 gradient compression and the GPipe schedule against the reference.

Compression: ``quantize``, ``dequantize`` and ``compress_decompress`` on
the same numpy input give the reference's int8 values, scales and
residuals bit for bit (both round half to even), also over several
steps of error feedback and for an all-zero gradient; ``ErrorFeedback``
as ``make_train_step``'s ``grad_transform`` equals compressing by hand
between the gradient and AdamW, bit for bit.  ``int8_psum``
runs on 4 gloo ranks (``tests/_torch_dist.py``, scenario
``collectives``) and equals the reference's formula computed in numpy
(one scale from the largest |x| of any rank, int8 values summed as int32,
divided by the rank count) exactly, and the true mean to within the
reference test's bound of 1.5 scales.  GPipe: ``gpipe_apply`` over a
4-stage axis equals the sequential stages (the reference test's
rtol/atol 1e-5), and ``bubble_fraction`` gives the reference's three
cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import launch
from repro.parallel.compression import (compress_decompress as jax_cd,
                                        init_residuals as jax_init_res,
                                        quantize as jax_quantize)
from repro_torch.parallel.compression import (ErrorFeedback,
                                              compress_decompress,
                                              dequantize, init_residuals,
                                              quantize)
from repro_torch.parallel.pipeline import bubble_fraction


def _grads(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"w": (r.standard_normal((32, 48)) * scale).astype(np.float32),
            "layers": [{"b": (r.standard_normal(17) * scale * 3).astype(
                np.float32)}]}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.5])
def test_quantize_is_the_reference_bit_for_bit(scale):
    g = _grads(1, scale)["w"]
    q, s = quantize(torch.from_numpy(g))
    jq, js = jax_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    err = np.abs(dequantize(q, s).numpy() - g)
    assert err.max() <= float(s) / 2 + 1e-6


def test_round_half_to_even_in_both():
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    q, _ = quantize(torch.from_numpy(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_quantize(
        jnp.asarray(g))[0]))


def test_error_feedback_steps_match_reference_bitwise():
    """Five steps of compress_decompress with carried residuals."""
    res, jres = None, None
    for i in range(5):
        g = _grads(10 + i, 0.01 * (1 + i))
        tg = {"w": torch.from_numpy(g["w"]),
              "layers": [{"b": torch.from_numpy(g["layers"][0]["b"])}]}
        jg = jax.tree.map(jnp.asarray, g)
        res = init_residuals(tg) if res is None else res
        jres = jax_init_res(jg) if jres is None else jres
        hat, res = compress_decompress(tg, res)
        jhat, jres = jax_cd(jg, jres)
        for a, b in ((hat["w"], jhat["w"]), (res["w"], jres["w"]),
                     (hat["layers"][0]["b"], jhat["layers"][0]["b"]),
                     (res["layers"][0]["b"], jres["layers"][0]["b"])):
            assert _np(a).tobytes() == np.asarray(b).tobytes()


def test_error_feedback_transform_carries_residuals():
    ef = ErrorFeedback()
    g = {"w": torch.from_numpy(_grads(2, 0.01)["w"])}
    total_hat = torch.zeros_like(g["w"])
    for i in range(6):
        total_hat += ef({"w": g["w"] * (1 + 0.1 * i)})["w"]
    total = sum(g["w"] * (1 + 0.1 * i) for i in range(6))
    gap = (total - total_hat - ef.residuals["w"]).abs().max()
    assert float(gap) < 1e-5


def test_zero_gradient_stays_zero():
    g = {"w": torch.zeros(8, 8)}
    hat, res = compress_decompress(g, init_residuals(g))
    assert not hat["w"].any() and not res["w"].any()


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 4) == 3 / 7
    assert bubble_fraction(2, 14) == 1 / 15


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    r = np.random.default_rng(0)
    x = (r.standard_normal((4, 8, 128)) * 2.0).astype(np.float32)
    ws = (r.standard_normal((4, 8, 8)) * 0.3).astype(np.float32)
    micro = r.standard_normal((6, 2, 8)).astype(np.float32)
    torch.save({"x": torch.from_numpy(x), "ws": torch.from_numpy(ws),
                "micro": torch.from_numpy(micro)}, tmp / "in.pt")
    return launch("collectives", 4, tmp), x, ws, micro


def test_int8_psum_is_the_reference_formula(ranks):
    outs, x, _, _ = ranks
    n = x.shape[0]
    scale = np.maximum(np.float32(np.abs(x).max()) / np.float32(127.0),
                       np.float32(1e-30))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    want = (q.astype(np.int32).sum(0).astype(np.float32) * scale
            / np.float32(n)).astype(np.float32)
    for out in outs:
        np.testing.assert_array_equal(out["psum"].numpy(), want)
        err = np.abs(out["psum"].numpy() - x.mean(0))
        assert err.max() <= scale * 1.5


def test_gpipe_matches_sequential(ranks):
    outs, _, ws, micro = ranks
    ref = torch.from_numpy(micro)
    for s in range(ws.shape[0]):
        ref = torch.tanh(ref @ torch.from_numpy(ws[s]))
    for out in outs:
        np.testing.assert_allclose(out["gpipe"].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_error_feedback_plugs_into_the_train_step():
    """``ErrorFeedback`` as ``make_train_step``'s ``grad_transform``: the
    step updates with the compressed gradient and keeps its residuals,
    equal to compressing by hand between ``loss_and_grads`` and AdamW."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import (OptConfig, adamw_update, init_opt_state,
                                   make_train_step)
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              dtype="float32", use_kernels=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    r = np.random.default_rng(5)
    batch = {k: torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ef = ErrorFeedback()
    got, _, _ = make_train_step(cfg, opt, grad_transform=ef)(
        params, init_opt_state(params), batch)
    _, _, grads = loss_and_grads(cfg, params, batch)
    hat, res = compress_decompress(grads, init_residuals(grads))
    want, _, _ = adamw_update(opt, params, hat, init_opt_state(params))
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(ef.residuals), leaves(res)):
        assert torch.equal(a, b)
