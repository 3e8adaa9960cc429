"""The port's train step against the reference's jitted step, and the
guard that keeps the kernels off the training path.

Two steps from the same converted float32 weights and the same batches,
at microbatches 1 and 2: metrics to rtol 1e-4, parameters to the
reference's own tolerance for a bf16-quantised update (rtol 5e-3, atol
2e-3; ``tests/test_loss.py``).  The step is functional (its inputs stay
as they were), refuses ``use_kernels=True``, and every kernel wrapper
raises when an operand requires grad under grad mode."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_train import assert_trees_close, batches, models, to_port
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro.train.optim import OptConfig as JaxOptConfig
from repro.train.optim import init_opt_state as jax_init_opt_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import kernels
from repro_torch.models import loss_fn
from repro_torch.train import (OptConfig, init_opt_state, make_eval_step,
                               make_train_step)
from repro_torch.tree import leaves, tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")
OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_two_steps_match_reference(microbatches):
    jcfg, jparams, cfg, params = models("qwen2-7b")
    jstep = jax.jit(jax_make_train_step(
        jcfg, JaxOptConfig(**dataclasses.asdict(OPT)),
        microbatches=microbatches))
    step = make_train_step(cfg, OPT, microbatches=microbatches)
    jstate = (jparams, jax_init_opt_state(jparams))
    state = (params, init_opt_state(params))
    for i in range(2):
        jb, tb = batches(cfg.vocab_size, B=4, S=32, seed=10 + i)
        *jstate, jm = jstep(*jstate, jb)
        *state, m = step(*state, tb)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-12, err_msg=k)
    assert_trees_close(state[0], to_port(jstate[0]), rtol=5e-3, atol=2e-3)
    assert int(state[1]["step"]) == 2


def test_step_leaves_its_inputs_untouched():
    _, _, cfg, params = models("qwen3-moe-235b-a22b")
    _, tb = batches(cfg.vocab_size, B=4, S=16, seed=3)
    opt = init_opt_state(params)
    state = (params, opt)
    before = [t.clone() for t in leaves((state, tb))]
    step = make_train_step(cfg, OPT, microbatches=2)
    p1, o1, _ = step(params, opt, tb)
    p2, o2, _ = step(p1, o1, tb)     # a second step reads the first's output
    for t, b in zip(leaves((state, tb)), before):
        assert torch.equal(t, b)
        assert not t.requires_grad
    new = {id(t) for t in leaves((p2, o2))}
    assert not new & {id(t) for t in leaves(state)}
    assert all(p.grad is None for p in leaves(params))


def test_eval_step_is_the_loss():
    _, _, cfg, params = models("qwen2-7b")
    _, tb = batches(cfg.vocab_size, seed=5)
    got = make_eval_step(cfg)(params, tb)
    with torch.no_grad():
        loss, m = loss_fn(cfg, params, tb)
    assert float(got["loss"]) == float(loss)
    assert float(got["ce"]) == float(m["ce"])
    assert not got["loss"].requires_grad


def test_step_refuses_the_kernel_path():
    _, _, cfg, _ = models("qwen2-7b")
    with pytest.raises(ValueError, match="use_kernels=False"):
        make_train_step(dataclasses.replace(cfg, use_kernels=True))


def _kernel_calls():
    """Each public wrapper with small CPU operands it accepts."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    lens = torch.tensor([16], dtype=torch.int32)
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    return {
        "flash_attention": (kernels.flash_attention,
                            (r(1, 16, 4, 32), r(1, 16, 2, 32),
                             r(1, 16, 2, 32)), {}),
        "decode_attention": (kernels.decode_attention,
                             (r(1, 4, 32), r(1, 16, 2, 32), r(1, 16, 2, 32),
                              16), {}),
        "paged_decode_attention": (kernels.paged_decode_attention,
                                   (r(1, 4, 32), r(2, 16, 2, 32),
                                    r(2, 16, 2, 32), table, lens), {}),
        "moe_gmm": (kernels.moe_gmm, (r(2, 4, 8), r(2, 8, 16)), {}),
        "mamba2_ssd": (kernels.mamba2_ssd,
                       (r(1, 8, 2, 16), r(1, 8, 2).abs() * 0.1,
                        -r(2).abs(), r(1, 8, 1, 16), r(1, 8, 1, 16)), {}),
        "mfma_gemm": (kernels.mfma_gemm, (r(4, 8), r(8, 16), r(4, 16)), {}),
    }


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_kernel_wrappers_raise_under_grad(name):
    fn, args, kw = _kernel_calls()[name]
    with torch.no_grad():
        want = fn(*args, **kw)
    tensors = [a for a in args if isinstance(a, torch.Tensor)
               and a.is_floating_point()]
    for i, t in enumerate(tensors):
        grad_args = [a.detach().requires_grad_() if a is t else a
                     for a in args]
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            fn(*grad_args, **kw)
        with torch.no_grad():        # the same operands outside grad mode
            got = fn(*grad_args, **kw)
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
    assert fn(*args, **kw) is not None     # no operand requires grad


def test_train_forward_through_a_kernel_raises():
    """A loss on the kernel path never silently loses its gradient."""
    _, _, cfg, params = models("qwen2-7b")
    _, tb = batches(cfg.vocab_size, B=2, S=16, seed=6)
    kcfg = dataclasses.replace(cfg, use_kernels=True)
    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    with pytest.raises(RuntimeError, match="flash_attention: .*no backward"):
        loss_fn(kcfg, ps, tb)
