"""The attention math of ``repro_torch.models.attention`` against the
reference's, in float32 on the CPU.

* ``_flash_sdpa``, the blockwise path the plain route takes from 2048
  keys on: causal and not, a ragged T, per-request ``kv_len``, a query
  offset and grouped heads.
* ``attention(use_kernels=False)`` at T = 4096 causal, where both sides
  split the causal triangle (``_causal_split_flash``), and at T = 2048
  with ``kv_len``.
* The kernel route raises ``NotImplementedError`` for what the kernels
  cannot take (an MLA-style value head dim, a custom softmax scale)
  instead of falling back.

Tolerance: rtol and atol 1e-5 (the frameworks sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.models import attention as attn

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, S, T, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal,kv_len,q_offset", [
    (True, None, 0), (False, None, 0), (False, [70, 150], 0),
    (True, None, 30)])
def test_flash_sdpa_matches_reference(causal, kv_len, q_offset):
    q, k, v = _qkv(2, 40 if q_offset else 150, 150, 4, 2, 16, seed=1)
    if q_offset:            # q is the tail of a longer causal sequence
        q = q[:, :40]
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jax_attn._flash_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=0.2, kv_len=None if kl is None else jnp.asarray(kl),
        q_offset=q_offset, block=64)
    got = attn._flash_sdpa(*_t((q, k, v)), causal=causal, scale=0.2,
                           kv_len=None if kl is None else torch.from_numpy(kl),
                           q_offset=q_offset, block=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,T,causal,kv_len", [
    (4096, 4096, True, None), (8, 2048, False, 1500)])
def test_long_plain_attention_matches_reference(S, T, causal, kv_len):
    q, k, v = _qkv(1, S, T, 2, 1, 16, seed=2)
    want = jax_attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, kv_len=kv_len)
    got = attn.attention(*_t((q, k, v)), causal=causal, kv_len=kv_len,
                         use_kernels=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 5])
def test_kernel_route_raises_instead_of_falling_back(S):
    q, k, v = _t(_qkv(1, S, 16, 4, 2, 32, seed=3))
    with pytest.raises(NotImplementedError, match="MLA"):
        attn.attention(q, k, v[..., :16].contiguous(), causal=S > 1,
                       use_kernels=True)
    with pytest.raises(NotImplementedError, match="softmax scale"):
        attn.attention(q, k, v, causal=S > 1, scale=0.3, use_kernels=True)
