"""The CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernel has no CPU mode).  This file imports neither jax nor the
reference, so it runs on a GPU machine with only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: bfloat16 atol 1e-2 (about one bf16 ulp at the outputs'
magnitude; the kernel and the plain version round at the same points
but sum in different orders), float32 atol 1e-5.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (launch_counts, paged_decode_attention,
                                 paged_decode_attention_plain)
from repro_torch.models import init_params
from repro_torch.serve import OK, PagedServeEngine, get_trace
from repro_torch.serve.parity import divergences

ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(G, page, hd, dtype, *, KV=4, B=5, seed=0):
    """Ragged lengths (two pages and a partial third, one page, one page
    plus a row, a single row, an idle slot on the poisoned null block)."""
    g = torch.Generator().manual_seed(seed)
    NB = 3
    P = B * NB + 1
    q = torch.randn((B, G * KV, hd), generator=g)
    kp = torch.randn((P, page, KV, hd), generator=g)
    vp = torch.randn((P, page, KV, hd), generator=g)
    kp[0], vp[0] = 40.0, -40.0
    lens = [2 * page + 5, page, page + 1, 1, 1][:B]
    tables = torch.zeros((B, NB), dtype=torch.int32)
    for b, n in enumerate(lens[:-1]):
        used = math.ceil(n / page)
        tables[b, :used] = torch.arange(1 + b * NB, 1 + b * NB + used)
    return ([t.to(dtype).cuda() for t in (q, kp, vp)]
            + [tables.cuda(), torch.tensor(lens, dtype=torch.int32).cuda()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,page,hd", [(1, 16, 32), (2, 128, 32),
                                       (7, 64, 128), (8, 32, 256)])
def test_kernel_matches_plain(cuda, G, page, hd, dtype):
    args = _case(G, page, hd, dtype, seed=G)
    before = launch_counts()["paged_decode_attention"]
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode_attention"] == before + 1
    want = paged_decode_attention_plain(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=ATOL[dtype])


@pytest.mark.cuda
def test_engine_kernel_path_matches_plain_path(cuda):
    """The reduced qwen2-7b served on the card: the kernel path launches
    once per layer per decode tick and its greedy streams match the
    plain path's up to near-ties."""
    cfg = get_config("qwen2-7b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    reqs = get_trace("base")(6, cfg.vocab_size, seed=1)
    kernel = PagedServeEngine(cfg, params, max_len=128, max_batch=4)
    plain = PagedServeEngine(dataclasses.replace(cfg, use_kernels=False),
                             params, max_len=128, max_batch=4)
    before = launch_counts()["paged_decode_attention"]
    k_res, k_stats = kernel.run(reqs)
    assert launch_counts()["paged_decode_attention"] - before == \
        cfg.n_layers * k_stats.decode_steps
    p_res, p_stats = plain.run(reqs)
    assert [r.status for r in k_res] == [OK] * len(reqs)
    assert k_stats.ticks == p_stats.ticks
    assert all(d["near_tie"] for d in divergences(plain, reqs, p_res, k_res))
