"""llama-3.2-vision-90b against the reference, reduced, on the CPU: gated
cross-attention over media embeddings.

The reduced config has 4 layers, period 2: self-attention at 0 and 2,
cross-attention at 1 and 3, over 16 media rows; its gates are drawn from
the seed (``tests/_torch_catalog.py``: the reference starts them at
zero, where no cross-attention would reach the residual).

* The ``"cross"`` layer and the ``"attn_cross"`` layer (self-attention,
  then a cross sub-block; no catalog schedule yields it, so it is held
  at the layer level only) in train, prefill and decode, float32 (rtol
  1e-5) and bfloat16 (rtol 2e-2), both paths.
* ``forward``, ``prefill`` and ``decode_step`` in float32 and bfloat16
  on both paths; the reference's Pallas kernels must have run on its
  kernel path.  Under ``use_kernels`` a prefill calls
  ``flash_attention`` once per layer (causal for self-attention, not for
  the cross layers, whose keys are the media rows) and a decode step
  ``decode_attention`` once per layer (over all media rows for a cross
  layer).
* The model-level greedy loop (the reference's engines do not take
  media) gives the reference's float32 tokens.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jax_blocks
from repro.models.model import init_cache as jax_init_cache
from repro_torch.convert import to_tensor
from repro_torch.models import blocks, decode_step, forward, init_cache, \
    prefill

from _torch_catalog import (CASE_IDS, CASES, RTOL, batches, check_forward,
                            check_prefill_decode, close, engine_streams,
                            greedy_streams, models)

ARCH = "llama-3.2-vision-90b"
PREFILL = {"flash_attention": True}
ATTN = sys.modules["repro_torch.models.attention"]


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _layer_case(dtype, kernels, sig, seed):
    """Reference and port weights of one ``sig`` layer (a cross gate of
    0.5), an input, media and positions."""
    jcfg, _, cfg, _ = models(ARCH, dtype, kernels)
    jw = jax_blocks.init_layer(jcfg, jax.random.PRNGKey(seed), sig)
    if "gate" in jw:
        jw["gate"] = jnp.float32(0.5)
    w = jax.tree.map(_t, jw)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    media = (rng.standard_normal((2, 16, cfg.d_model)) * 0.5
             ).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    return jcfg, jw, cfg, w, h, media, x1


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("mixer", ["cross", "attn_cross"])
def test_cross_layer_modes_match_reference(mixer, dtype, kernels):
    sig = (mixer, False)
    jcfg, jw, cfg, w, h, media, x1 = _layer_case(dtype, kernels, sig, 3)
    rtol = RTOL[dtype]
    tdt = getattr(torch, dtype)
    jh, jm, jx = (jnp.asarray(a).astype(dtype) for a in (h, media, x1))
    th, tm, tx = (torch.from_numpy(a).to(tdt) for a in (h, media, x1))
    pos = np.arange(11, dtype=np.int32)
    jy, _ = jax_blocks.apply_layer(jcfg, sig, jw, jh, mode="train",
                                   positions=jnp.asarray(pos), media=jm)
    y, _ = blocks.apply_layer(cfg, sig, w, th, mode="train",
                              positions=torch.from_numpy(pos), media=tm)
    close(y, jy, rtol)
    jy, _, jc = jax_blocks.apply_layer(jcfg, sig, jw, jh, mode="prefill",
                                       positions=jnp.asarray(pos), media=jm,
                                       max_len=16)
    y, _, c = blocks.apply_layer(cfg, sig, w, th, mode="prefill",
                                 positions=torch.from_numpy(pos), media=tm,
                                 max_len=16)
    close(y, jy, rtol)
    assert set(c) == set(jc) == ({"ck", "cv"} if mixer == "cross"
                                 else {"k", "v", "ck", "cv"})
    assert c["ck"].shape == (2, 16, cfg.n_kv_heads, cfg.hd)
    for n in c:
        close(c[n], jc[n], rtol)
    carried = {n: _t(a) for n, a in jc.items()}
    jy, jc = jax_blocks.apply_layer(jcfg, sig, jw, jx, mode="decode",
                                    cache=jc, pos=jnp.int32(11))
    y, c = blocks.apply_layer(cfg, sig, w, tx, mode="decode", cache=carried,
                              pos=11)
    assert c is carried
    close(y, jy, rtol)
    for n in c:
        close(c[n], jc[n], rtol)


def test_gate_scales_the_cross_attention():
    """A cross layer's output is ``h + tanh(gate) * cross(norm(h))`` plus
    its FFN: at gate 0 the media do not matter, at 0.5 they do."""
    _, _, cfg, w, h, media, _ = _layer_case("float32", False,
                                            ("cross", False), 4)
    th, pos = torch.from_numpy(h), torch.arange(11, dtype=torch.int32)

    def run(gate, m):
        ww = dict(w, gate=torch.tensor(gate))
        return blocks.apply_layer(cfg, ("cross", False), ww, th,
                                  mode="train", positions=pos, media=m)[0]

    m1 = torch.from_numpy(media)
    m2 = -2.0 * m1
    torch.testing.assert_close(run(0.0, m1), run(0.0, m2), rtol=0, atol=0)
    assert float((run(0.5, m1) - run(0.5, m2)).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
def test_forward_train_matches_reference(dtype, kernels):
    check_forward(ARCH, dtype, kernels, PREFILL)


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
def test_prefill_and_decode_step_match_reference(dtype, kernels):
    check_prefill_decode(ARCH, dtype, kernels, PREFILL)


def test_media_reach_the_logits():
    """With the seed's gates, other media give other logits."""
    _, _, cfg, params = models(ARCH)
    _, tb = batches(cfg, 2, 9, 5)
    _, other = batches(cfg, 2, 9, 6)
    a = forward(cfg, params, tb)[0]
    b = forward(cfg, params, dict(tb, media=other["media"]))[0]
    assert float((a - b).abs().max()) > 1e-3


def test_kernel_calls_per_layer(monkeypatch):
    """A prefill: flash once per layer, causal for the self-attention
    layers and not for the cross layers (T = the media rows); a decode
    step: decode once per layer, over every media row for a cross
    layer."""
    calls = []

    def wrap(name):
        fn = getattr(ATTN, name)

        def counted(q, k, v, *a, **kw):
            calls.append((name, kw.get("causal"), k.shape[1],
                          a[0] if a else kw.get("kv_len")))
            return fn(q, k, v, *a, **kw)
        monkeypatch.setattr(ATTN, name, counted)

    wrap("flash_attention")
    wrap("decode_attention")
    _, _, cfg, params = models(ARCH, "float32", True)
    _, tb = batches(cfg, 2, 9, 5)
    _, cache = prefill(cfg, params, tb, 16)
    M = cfg.cross_attn.n_media_tokens
    assert calls == [("flash_attention", True, 9, None),
                     ("flash_attention", False, M, None)] * 2
    calls.clear()
    decode_step(cfg, params, cache, tb["tokens"][:, :1], 9)
    assert calls == [("decode_attention", None, 16, 10),
                     ("decode_attention", None, M, M)] * 2


def test_init_cache_media_rows_default_to_the_config():
    jcfg, _, cfg, _ = models(ARCH)
    M = cfg.cross_attn.n_media_tokens
    got = init_cache(cfg, 2, 32, device="cpu")
    want = jax_init_cache(jcfg, 2, 32)
    assert [set(c) for c in got] == [{"k", "v"}, {"ck", "cv"}] * 2
    assert got[1]["ck"].shape == want["layers"][1]["ck"].shape[1:] == \
        (2, M, cfg.n_kv_heads, cfg.hd)
    assert init_cache(cfg, 2, 32, 5, device="cpu")[3]["cv"].shape[1] == 5


def test_convert_carries_the_gates():
    jcfg, jparams, cfg, params = models(ARCH)
    gates = np.asarray(jparams["layers"][1]["gate"])
    assert gates.shape == (2,) and (gates > 0).all()
    for i, layer in enumerate(params["layers"][1::2]):
        assert layer["gate"].dtype == torch.float32 and \
            layer["gate"].shape == ()
        assert float(layer["gate"]) == float(gates[i])


def test_greedy_loop_matches_reference():
    ref, got = greedy_streams(ARCH)
    np.testing.assert_array_equal(got, ref)


def test_engine_generate_with_media_matches_reference():
    """``ServeEngine.generate(extras={"media": ...})``, greedy, in
    float32: the same stream as the reference engine's."""
    ref, got = engine_streams(ARCH)
    assert got.shape == ref.shape == (2, 8)
    np.testing.assert_array_equal(got, ref)
