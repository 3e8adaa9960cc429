"""whisper-base against the reference, reduced, on the CPU: the encoder
(``_encode``, ``"enc_attn"`` blocks), learned positions, LayerNorm and
a GELU MLP, tied embeddings.

The reduced config has 2 encoder layers over 32 frames and 4 decoder
layers.  The decoder's layers are plain self-attention in both packages:
the reference's ``layer_sigs`` yields cross layers only for ``cross_attn``
configs, so its decoder never reads the encoder's output and its logits
do not depend on the frames.  The port computes the same function (and
runs the encoder all the same, as the reference's ``forward`` does);
``_encode`` is held to the reference's directly.

* ``_encode`` in float32 (rtol 1e-5) and bfloat16 (rtol 2e-2) on both
  paths; ``forward``, ``prefill`` and ``decode_step`` likewise, the
  reference's Pallas kernels asserted on its kernel path.
* Under ``use_kernels`` a prefill calls ``flash_attention`` non-causal
  once per encoder layer (S = T = the frames) and causal once per
  decoder layer.
* The model-level greedy loop gives the reference's float32 tokens;
  the paged steps refuse learned positions, as the reference's do.
"""

import sys

import numpy as np
import pytest
import torch

from repro.kernels import dispatch as kdispatch
from repro.models import model as jax_model
from repro_torch.models import forward, init_params, paged_decode_step, \
    prefill

from _torch_catalog import (CASE_IDS, CASES, RTOL, batches, check_forward,
                            check_prefill_decode, close, engine_streams,
                            greedy_streams, models)

ARCH = "whisper-base"
PREFILL = {"flash_attention": True}
ATTN = sys.modules["repro_torch.models.attention"]
model = sys.modules["repro_torch.models.model"]


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
def test_encode_matches_reference(dtype, kernels):
    jcfg, jparams, cfg, params = models(ARCH, dtype, kernels)
    jb, tb = batches(cfg, 2, 5, 3)
    with kdispatch.decision_scope() as decisions:
        want = jax_model._encode(jcfg, jparams, jb["frames"])
    assert bool(decisions) == kernels
    got = model._encode(cfg, params, tb["frames"])
    assert got.shape == (2, cfg.encoder.n_frames, cfg.d_model)
    assert got.dtype == tb["frames"].dtype
    close(got, want, RTOL[dtype])


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
def test_forward_train_matches_reference(dtype, kernels):
    check_forward(ARCH, dtype, kernels, PREFILL)


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
def test_prefill_and_decode_step_match_reference(dtype, kernels):
    check_prefill_decode(ARCH, dtype, kernels, PREFILL)


def test_convert_carries_encoder_and_positions():
    """The encoder's one-slot stack becomes a list of its layers; the
    learned-position tables come across bit for bit."""
    _, jparams, cfg, params = models(ARCH)
    enc, jenc = params["encoder"], jparams["encoder"]
    assert set(enc) == {"pos", "layers", "norm"}
    assert len(enc["layers"]) == cfg.encoder.n_layers
    assert enc["pos"].shape == (cfg.encoder.n_frames, cfg.d_model)
    assert params["pos_embed"].shape == (model.LEARNED_POS_LEN, cfg.d_model)
    np.testing.assert_array_equal(params["pos_embed"].numpy(),
                                  np.asarray(jparams["pos_embed"]))
    for i, layer in enumerate(enc["layers"]):
        assert set(layer) == {"ln1", "ln2", "mixer", "ffn"}
        assert set(layer["ffn"]) == {"wi", "bi", "wo", "bo"}
        np.testing.assert_array_equal(
            layer["mixer"]["wq"].numpy(),
            np.asarray(jenc["layers"][0]["mixer"]["wq"][i]))
    assert "unembed" not in params                  # tied embeddings


def test_init_params_draws_encoder_and_positions():
    _, jparams, cfg, params = models(ARCH)
    drawn = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(drawn) == shapes(params)


def test_logits_do_not_read_the_frames():
    """The reference's decoder never attends the encoder output, so other
    frames give the same logits on both sides."""
    jcfg, jparams, cfg, params = models(ARCH)
    jb, tb = batches(cfg, 2, 9, 5)
    jo, to = batches(cfg, 2, 9, 6)
    assert float((to["frames"] - tb["frames"]).abs().max()) > 0.1
    for fwd, b, o, p, c in ((jax_model.forward, jb, jo, jparams, jcfg),
                            (forward, tb, to, params, cfg)):
        a = np.asarray(fwd(c, p, b)[0])
        z = np.asarray(fwd(c, p, dict(b, frames=o["frames"]))[0])
        np.testing.assert_array_equal(a, z)


def test_kernel_calls_per_layer(monkeypatch):
    calls = []
    fn = ATTN.flash_attention

    def counted(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return fn(q, k, v, **kw)

    monkeypatch.setattr(ATTN, "flash_attention", counted)
    _, _, cfg, params = models(ARCH, "float32", True)
    _, tb = batches(cfg, 2, 9, 5)
    prefill(cfg, params, tb, 16)
    F = cfg.encoder.n_frames
    assert calls == [(False, F, F)] * cfg.encoder.n_layers \
        + [(True, 9, 9)] * cfg.n_layers


def test_greedy_loop_matches_reference():
    ref, got = greedy_streams(ARCH)
    np.testing.assert_array_equal(got, ref)


def test_engine_generate_with_frames_matches_reference():
    """``ServeEngine.generate(extras={"frames": ...})``, greedy, in
    float32: the same stream as the reference engine's."""
    ref, got = engine_streams(ARCH)
    assert got.shape == ref.shape == (2, 8)
    np.testing.assert_array_equal(got, ref)


def test_paged_steps_refuse_learned_positions():
    _, _, cfg, params = models(ARCH)
    one = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="rope positions"):
        paged_decode_step(cfg, params, {}, one, one, one[0])
