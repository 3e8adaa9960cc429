"""The paged serving steps against the reference, in float32.

``paged_decode_step`` and ``paged_prefill_step`` run on the reduced
qwen2-7b with the reference's weights (converted) and the same random
pools, tables and lengths; the reference runs its ``use_pallas=False``
path.  The port runs both of its paths: ``use_kernels=True`` (the
kernel's plain version on the CPU) and ``use_kernels=False`` (gather
plus plain attention).  Logits and every pool row must agree to rtol
1e-5, with an absolute floor of 1e-5 times the largest magnitude (the
frameworks sum in different orders).  Prefill covers both write paths:
the aligned single-block window and the row scatter that sends padded
rows to the null block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models.model import paged_decode_step as jax_decode
from repro.models.model import paged_prefill_step as jax_prefill
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.models import paged_decode_step, paged_prefill_step

JCFG = dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                           dtype="float32")
CFG = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype="float32")
JPARAMS = jax_init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = convert_params(jax.tree.map(np.asarray, JPARAMS), device="cpu")
PAGE, P = 128, 7
RTOL = 1e-5


def _close(port, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(ref).max()))


def _pools(seed):
    rng = np.random.default_rng(seed)
    shp = (CFG.n_layers, P, PAGE, CFG.n_kv_heads, CFG.hd)
    return {n: rng.standard_normal(shp).astype(np.float32) for n in "kv"}


def _both(pools_np):
    jpools = {"layers0": [], "layers": ({n: jnp.asarray(a)
                                         for n, a in pools_np.items()},)}
    tpools = {n: torch.from_numpy(a.copy()) for n, a in pools_np.items()}
    return jpools, tpools


def _check_pools(tpools, jnew):
    for n in "kv":
        _close(tpools[n], jnew["layers"][0][n])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_paged_decode_step_matches_reference(use_kernels):
    pools = _pools(1)
    # ragged lengths: two pages and a partial third row, a page boundary
    # write, a short request, and an idle slot on the null block
    tables = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 6], [0, 0, 0]], np.int32)
    lens = np.array([150, 40, 256, 0], np.int32)
    toks = np.random.default_rng(1).integers(
        0, CFG.vocab_size, (4, 1)).astype(np.int32)
    jpools, tpools = _both(pools)
    jl, jnew = jax_decode(JCFG, JPARAMS, jpools, jnp.asarray(toks),
                          jnp.asarray(tables), jnp.asarray(lens))
    cfg = dataclasses.replace(CFG, use_kernels=use_kernels)
    tl = paged_decode_step(cfg, PARAMS, tpools, torch.from_numpy(toks),
                           torch.from_numpy(tables), torch.from_numpy(lens))
    assert tl.shape == (4, 1, CFG.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    _check_pools(tpools, jnew)


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned_window", "row_scatter"])
def test_paged_prefill_step_matches_reference(aligned):
    rng = np.random.default_rng(2)
    if aligned:
        # B == 1, a 32-row chunk at offset 64 inside block 3, 20 valid
        tables = np.array([[5, 3, 0]], np.int32)
        lens = np.array([160], np.int32)
        nv = np.array([20], np.int32)
        C = 32
    else:
        # request 0 crosses a page boundary (100..147); request 1 is a
        # 30-row first chunk whose padded rows go to the null block
        tables = np.array([[1, 2, 0], [4, 0, 0]], np.int32)
        lens = np.array([100, 0], np.int32)
        nv = np.array([48, 30], np.int32)
        C = 48
    toks = rng.integers(0, CFG.vocab_size, (len(lens), C)).astype(np.int32)
    jpools, tpools = _both(_pools(3))
    jl, jnew = jax_prefill(JCFG, JPARAMS, jpools, jnp.asarray(toks),
                           jnp.asarray(tables), jnp.asarray(lens),
                           jnp.asarray(nv), aligned=aligned)
    tl = paged_prefill_step(CFG, PARAMS, tpools, torch.from_numpy(toks),
                            torch.from_numpy(tables), torch.from_numpy(lens),
                            torch.from_numpy(nv), aligned=aligned)
    assert tl.shape == (len(lens), 1, CFG.vocab_size)
    _close(tl, jl)
    _check_pools(tpools, jnew)


def test_prefill_then_decode_continues_the_sequence():
    """Prefilling a prompt and decoding its next token through the pool
    gives the logits a one-shot prefill of the longer prompt gives."""
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, CFG.vocab_size, (1, 37)).astype(np.int32)
    tables = torch.tensor([[2, 0, 0]], dtype=torch.int32)
    _, pools = _both(_pools(5))
    paged_prefill_step(CFG, PARAMS, pools, torch.from_numpy(prompt[:, :36]),
                       tables, torch.tensor([0], dtype=torch.int32),
                       torch.tensor([36], dtype=torch.int32))
    step = paged_decode_step(CFG, PARAMS, pools,
                             torch.from_numpy(prompt[:, 36:]), tables,
                             torch.tensor([36], dtype=torch.int32))
    _, fresh = _both(_pools(6))
    whole = paged_prefill_step(CFG, PARAMS, fresh, torch.from_numpy(prompt),
                               tables, torch.tensor([0], dtype=torch.int32),
                               torch.tensor([37], dtype=torch.int32))
    _close(step, whole.numpy())
