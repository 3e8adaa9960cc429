"""The benchmark's plain references against the port's plain path.

At reduced sizes on the CPU, for both families: the port's paged engine
prefills a prompt in its chunks and decodes a stream through the paged
cache (``teacher_forced_logits``, plain path: ``use_kernels=False``);
the reference runs the whole sequence at once.  In float32 the two
agree to rounding; in bf16 to the rounding of the port's bf16
activations.  This test imports the port; the references do not.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from h100bench import model, weights  # noqa: E402
from h100bench.registry import Registry  # noqa: E402

REG = Registry()


def small(name: str, dtype: str = "float32") -> dict:
    """The cell's config file at a size the CPU holds."""
    c = dict(REG.config(name))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, num_hidden_layers=2, vocab_size=256,
             torch_dtype=dtype)
    if "num_experts" in c:
        c.update(num_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=32)
    else:
        c.update(intermediate_size=96)
    return c


def served_logits(c, params, prompt, tokens, chunk):
    from repro_torch.serve import PagedServeEngine
    cfg = dataclasses.replace(model.port_config(c), use_kernels=False)
    eng = PagedServeEngine(cfg, params, max_len=128, max_batch=2, page=16,
                           prefill_chunk=chunk, device="cpu")
    out = eng.teacher_forced_logits(prompt, tokens)
    return torch.stack([o.float() for o in out])


def reference_logits(c, params, prompt, tokens, chunk):
    ref = REG.reference(c["reference"])
    seq = torch.tensor(np.concatenate([prompt, tokens[:-1]]))
    s = len(prompt)
    groups = [(a, min(a + chunk, s), chunk) for a in range(0, s, chunk)]
    return ref.logits(c, params, [seq], [s - 1], [groups])[0]


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-moe-8l"])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 6e-2)])
def test_reference_matches_the_ports_plain_path(name, dtype, tol):
    torch.manual_seed(0)
    c = small(name, dtype)
    params = weights.make_weights(c, 1234567, "cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, c["vocab_size"], 45).astype(np.int32)
    tokens = rng.integers(0, c["vocab_size"], 9).astype(np.int32)
    got = served_logits(c, params, prompt, tokens, chunk=16)
    want = reference_logits(c, params, prompt, tokens, chunk=16)
    assert got.shape == want.shape == (9, c["vocab_size"])
    err = (got - want).abs().max() / want.abs().max()
    assert err < tol, f"{name} {dtype}: relative error {err:.3g}"


def test_moe_reference_matches_the_port_where_experts_overflow():
    """Capacity factor 0.5: 4 slots an expert for 4 assignments on
    average in a chunk of 16, so many assignments drop, on both sides
    alike."""
    c = small("qwen3-moe-8l")
    c["capacity_factor"] = 0.5
    params = weights.make_weights(c, 77, "cpu")
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, c["vocab_size"], 45).astype(np.int32)
    tokens = rng.integers(0, c["vocab_size"], 5).astype(np.int32)
    ref = REG.reference(c["reference"])
    x = torch.randn(16, c["hidden_size"])
    _, idx = ref.route(c, params["layers"][0]["ffn"], x)
    assert not ref.keep_mask(c, idx, [(0, 16, 16)]).all()
    got = served_logits(c, params, prompt, tokens, chunk=16)
    want = reference_logits(c, params, prompt, tokens, chunk=16)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 2e-4, f"relative error {err:.3g}"


def test_moe_reference_drops_past_capacity_as_the_port_does():
    """Eight experts, two a token, chunks of 16: capacity 8 a group.
    Route every token to the same two experts and the reference keeps
    the first 8 tokens' assignments of a chunk, as the port's groups do."""
    c = small("qwen3-moe-8l")
    ref = REG.reference(c["reference"])
    assert ref.capacity(c, 16) == 8
    idx = torch.tensor([[0, 1]] * 16)
    keep = ref.keep_mask(c, idx, [(0, 16, 16)])
    assert keep[:8].all() and not keep[8:].any()
    keep = ref.keep_mask(c, idx, [])
    assert keep.all()
