"""The routing near-tie rule of ``repro_torch.serve.parity`` on the CPU.

``routing_differences`` is checked on hand-made router probabilities,
``routing_log`` on the reduced qwen3-moe (it must see one call per MoE
layer and change nothing), and ``divergences(engine=...)`` on the
reduced MoE model served by the paged engine on its kernel path (the
kernels' plain versions on the CPU) against its plain path, in bfloat16,
where the two paths round differently.  The routing margin there is
1e-2: the reduced router spreads over 4 experts, not 128, so its top-2
probabilities are ~8x the full model's top-8 ones and the same
router-logit gap is a ~8x larger probability margin than 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import forward, init_params
from repro_torch.serve import PagedServeEngine, get_trace
from repro_torch.serve.parity import (NEAR_TIE, divergences,
                                      routing_differences, routing_log)

CFG = get_config("qwen3-moe-235b-a22b").reduced()
REDUCED_ROUTING_MARGIN = 1e-2


def test_routing_differences_finds_rows_and_reference_margins():
    ref = torch.tensor([[[0.40, 0.30, 0.20, 0.10],     # top-2 {0, 1}
                         [0.26, 0.25, 0.25, 0.24]]])   # top-2 {0, 1}, tie
    got = torch.tensor([[[0.30, 0.40, 0.20, 0.10],     # same set
                         [0.26, 0.24, 0.25, 0.25]]])   # {0, 2}
    diffs = routing_differences(2, [ref, got], [ref, ref])
    assert len(diffs) == 1
    call, rows = diffs[0]
    assert call == 1 and [r for r, _ in rows] == [1]
    assert rows[0][1] == pytest.approx(0.0)            # 0.25 - 0.25
    with pytest.raises(ValueError, match="do not pair up"):
        routing_differences(2, [ref], [ref, ref])


def test_routing_log_sees_every_moe_layer_and_changes_nothing():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 9)))
    want, _ = forward(CFG, params, {"tokens": toks})
    with routing_log() as log:
        got, _ = forward(CFG, params, {"tokens": toks})
    assert len(log) == CFG.n_layers
    assert all(p.shape == (2, 9, CFG.moe.n_experts) for p in log)
    torch.testing.assert_close(log[0].sum(-1), torch.ones((2, 9)))
    assert torch.equal(got, want)
    with routing_log() as log:                          # restored after
        pass
    forward(CFG, params, {"tokens": toks})
    assert log == []


def test_divergences_explain_moe_streams_by_routing():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    reqs = get_trace("shared_prefix")(8, CFG.vocab_size, seed=0,
                                      prefix_len=128)
    for r in reqs:
        r.n_steps = 16
    kernel = PagedServeEngine(CFG, params, max_len=256, max_batch=8,
                              page=64, device="cpu")
    plain = PagedServeEngine(dataclasses.replace(CFG, use_kernels=False),
                             params, max_len=256, max_batch=8, page=64,
                             device="cpu")
    k_res, _ = kernel.run(reqs)
    p_res, _ = plain.run(reqs)
    div = divergences(plain, reqs, p_res, k_res, engine=kernel,
                      routing_margin=REDUCED_ROUTING_MARGIN)
    assert all(d["near_tie"] for d in div), div
    assert any("routing" in d for d in div)       # the routing rule ran
    for d in div:
        if d["margin"] >= NEAR_TIE:
            assert d["routing"] is not None
            assert d["routing"]["margin"] < REDUCED_ROUTING_MARGIN
        else:
            assert "routing" not in d
    plain_only = divergences(plain, reqs, p_res, k_res)
    assert [d["step"] for d in plain_only] == [d["step"] for d in div]
    assert all("routing" not in d for d in plain_only)
