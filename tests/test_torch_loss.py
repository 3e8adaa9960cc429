"""The port's training loss against the reference: the chunked CE, the
loss and its parts on dense, MoE and SSM reduced configs, gradients leaf
by leaf (float32: rtol 1e-3, atol 1e-5; bfloat16: no further from the
reference's float32 gradient than 1.5x the reference's own bfloat16
gradient is), and the three remat policies."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_train import (assert_trees_close, batches, models, rel_dist,
                          reference_value_and_grad, to_port)
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro_torch.models import forward, loss_fn
from repro_torch.models.model import _chunked_ce
from repro_torch.train.step import loss_and_grads

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCHS = ("qwen2-7b", "qwen3-moe-235b-a22b", "mamba2-370m")


@pytest.mark.parametrize("B", [4, 3, 6, 1])
def test_chunked_ce_matches_log_softmax(B):
    _, _, cfg, params = models("qwen2-7b")
    _, batch = batches(cfg.vocab_size, B=B, S=16, seed=B)
    with torch.no_grad():
        loss, m = loss_fn(cfg, params, batch)
        logits, _ = forward(cfg, params, batch, mode="train")
    logp = torch.log_softmax(logits, dim=-1)
    want = -logp.gather(-1, batch["labels"].long()[..., None]).mean()
    np.testing.assert_allclose(float(m["ce"]), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(m["ce"] + m["aux"]),
                               rtol=1e-6)


def test_chunked_ce_gradient_matches_log_softmax():
    g = torch.Generator().manual_seed(0)
    h = torch.randn(4, 8, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 40, generator=g, requires_grad=True)
    labels = torch.randint(0, 40, (4, 8), generator=g)
    _, _, cfg, _ = models("qwen2-7b")
    got = torch.autograd.grad(_chunked_ce(cfg, h, w, labels), (h, w))
    ref = -torch.log_softmax(h @ w, -1).gather(-1, labels[..., None]).mean()
    want = torch.autograd.grad(ref, (h, w))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    jcfg, jparams, cfg, params = models(arch)
    jb, tb = batches(cfg.vocab_size, seed=1)
    (jloss, jm), _ = reference_value_and_grad(jcfg, jparams, jb)
    with torch.no_grad():
        loss, m = loss_fn(cfg, params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                               rtol=1e-5, atol=1e-8)
    if cfg.moe:
        assert float(m["aux"]) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_gradients_match_reference(arch):
    jcfg, jparams, cfg, params = models(arch)
    jb, tb = batches(cfg.vocab_size, seed=2)
    _, jgrads = reference_value_and_grad(jcfg, jparams, jb)
    loss, _, grads = loss_and_grads(cfg, params, tb)
    assert_trees_close(grads, to_port(jgrads), rtol=1e-3, atol=1e-5)


def test_bf16_gradient_within_the_reference_bf16_yardstick():
    """The same bf16 weights in both packages, and their float32 copy in
    the reference: the port's bf16 gradient may lie no further from the
    reference's float32 gradient than 1.5x the reference's bf16 one."""
    jcfg16, jp16, cfg16, tp16 = models("qwen2-7b", "bfloat16")
    jcfg32 = dataclasses.replace(jcfg16, dtype="float32")
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp16)
    jb, tb = batches(cfg16.vocab_size, seed=3)
    _, g32 = reference_value_and_grad(jcfg32, jp32, jb)
    _, g16 = reference_value_and_grad(jcfg16, jp16, jb)
    _, _, got = loss_and_grads(cfg16, tp16, tb)
    want = to_port(g32)
    yardstick = rel_dist(to_port(g16), want)
    port = rel_dist(got, want)
    print(f"bf16 gradient vs the reference's float32: port {port:.5f}, "
          f"the reference's own bf16 {yardstick:.5f}")
    assert 0.0 < yardstick < 5e-2
    assert port <= 1.5 * yardstick


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm,
                                   torch.ops.aten.addmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads_and_backward_products(cfg, params, batch):
    from repro_torch.tree import leaves, tree_map
    xs = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(xs)
    loss, _ = loss_fn(cfg, tree_map(lambda _: next(it), params), batch)
    with _CountProducts() as mode:
        gs = torch.autograd.grad(loss, xs, allow_unused=True,
                                 materialize_grads=True)
    return gs, mode.n


def test_remat_policies_give_equal_gradients():
    """"full", "dots" and "none" compute the same f32 gradient; "dots"
    keeps the layers' matmul outputs, so its backward recomputes none of
    them, where "full" recomputes every layer's."""
    got = {}
    for remat in ("full", "dots", "none"):
        _, _, cfg, params = models("qwen2-7b", remat=remat)
        _, tb = batches(cfg.vocab_size, seed=4)
        got[remat] = _grads_and_backward_products(cfg, params, tb)
    for remat in ("dots", "none"):
        for a, b in zip(got[remat][0], got["full"][0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got["dots"][1] == got["none"][1] < got["full"][1]
