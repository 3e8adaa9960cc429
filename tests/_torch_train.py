"""Shared set-up of the training tests (``test_torch_{loss,train_step,
optim,fault_tolerance,system}.py``): the reference's reduced model and
the port's twin with the reference's weights converted, batches of
tokens and labels drawn from a seed, the reference's jitted loss and
gradient, and a leaf-by-leaf comparison in the port's layout.  Both
packages train on their plain paths (``use_pallas=False``,
``use_kernels=False``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.tree import flatten_with_path


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tests on one PyTorch CPU thread.  The suite runs in
    several worker processes at once; a training step is thousands of
    small ops, and with every worker's OpenMP pool as wide as the machine
    each op's barrier waits on threads the other workers have taken (a
    60-step run went from 12 s alone to over 800 s).  One thread needs
    no barrier."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def models(arch, dtype="float32", seed=0, **overrides):
    """(reference cfg, reference params, port cfg, port params) of the
    reduced ``arch`` on the plain paths, ``overrides`` applied to both
    configs."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                               use_pallas=False, **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                              use_kernels=False, **overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, cfg, to_port(jparams)


def to_port(jtree):
    """A reference parameter-shaped tree (params or gradients) in the
    port's layout, on the CPU."""
    return convert_params(jax.tree.map(np.asarray, jtree), device="cpu")


def batches(vocab, B=4, S=32, seed=0):
    """The same random tokens and labels for the reference and the port."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labs = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)})


def reference_value_and_grad(jcfg, jparams, jbatch):
    """((loss, {"ce", "aux"}), grads) of the reference's loss_fn, jitted."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jcfg, p, b), has_aux=True))
    return fn(jparams, jbatch)


def named_leaves(tree):
    """[(path string, f32 numpy array)] in the port's layout order."""
    out = []
    for path, leaf in flatten_with_path(tree):
        a = leaf.detach().float().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf, np.float32)
        out.append(("/".join(map(str, path)), a))
    return out


def assert_trees_close(got, want, rtol, atol):
    g, w = named_leaves(got), named_leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def rel_dist(got, want) -> float:
    """||got - want|| / ||want|| over every leaf together (f32)."""
    num = den = 0.0
    for (_, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
        num += float(np.sum((a.astype(np.float64) - b) ** 2))
        den += float(np.sum(b.astype(np.float64) ** 2))
    return float(np.sqrt(num / den))
