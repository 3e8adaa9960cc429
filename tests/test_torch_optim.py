"""The port's AdamW, schedule and clipping: the six cases of
``tests/test_optim.py``, the schedule and one update against the
reference's (float32 to 1e-6; bfloat16 parameters equal or one ulp
apart), and the weight-decay mask on every reduced config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.train import optim as jax_optim
from repro_torch.convert import convert_params, to_tensor
from repro_torch.train.optim import (OptConfig, _decay_mask, adamw_update,
                                     global_norm, init_opt_state,
                                     lr_schedule)
from repro_torch.tree import flatten_with_path, tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_lr_schedule_shape():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1)
    lrs = [float(lr_schedule(cfg, s)) for s in range(100)]
    assert lrs[0] < lrs[9]                       # warmup rises
    assert abs(lrs[10] - 1e-3) < 1e-4            # peak after warmup
    assert lrs[-1] < lrs[50]                     # cosine decays
    assert lrs[-1] >= 0.1 * 1e-3 - 1e-9          # floor


def test_lr_schedule_equals_reference():
    cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=120,
                    min_lr_ratio=0.1)
    jcfg = jax_optim.OptConfig(**dataclasses.asdict(cfg))
    got = lr_schedule(cfg, torch.arange(151, dtype=torch.int32)).numpy()
    want = np.asarray(jax_optim.lr_schedule(jcfg, jnp.arange(151,
                                                             dtype=jnp.int32)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_minimises_quadratic():
    cfg = OptConfig(lr=0.05, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=100.0)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params)
    for _ in range(150):
        grads = {"x": 2 * params["x"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(params["x"].abs().max()) < 0.1


def test_grad_clipping():
    cfg = OptConfig(lr=1e-3, warmup_steps=0, clip_norm=1.0)
    params = {"x": torch.zeros((4,))}
    state = init_opt_state(params)
    huge = {"x": torch.full((4,), 1e6)}
    p2, state, m = adamw_update(cfg, params, huge, state)
    assert float(m["grad_norm"]) > 1e5           # reported raw norm
    assert bool(torch.isfinite(p2["x"]).all())
    # post-clip first moment bounded by (1-b1) * clip_norm
    assert float(state["m"]["x"].abs().max()) <= 1.0


def test_weight_decay_mask():
    """Norm-like leaves ('ln1', 'bias') are not decayed."""
    cfg = OptConfig(lr=0.1, warmup_steps=0, weight_decay=1.0, clip_norm=1e9)
    params = {"wq": torch.ones((2, 2)), "ln1": torch.ones((2,))}
    state = init_opt_state(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = adamw_update(cfg, params, zero_g, state)
    assert float(p2["wq"][0, 0]) < 1.0           # decayed
    assert float(p2["ln1"][0]) == pytest.approx(1.0)  # not decayed


def test_moments_are_f32():
    params = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    state = init_opt_state(params)
    assert state["m"]["w"].dtype == torch.float32
    assert state["v"]["w"].dtype == torch.float32
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    grads = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    p2, s2, _ = adamw_update(OptConfig(), params, grads, state)
    assert p2["w"].dtype == torch.bfloat16       # params keep their dtype
    assert s2["v"]["w"].dtype == torch.float32


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)


def _tree(dtype, seed):
    """A small parameter-like tree with decayed and undecayed leaves."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": leaf(16, 8), "final_norm": leaf(8),
            "layers": [{"ln1": leaf(8), "mixer": {"wq": leaf(8, 8),
                                                 "bq": leaf(8)}},
                       {"ln1": leaf(8), "mixer": {"wq": leaf(8, 8),
                                                 "bq": leaf(8)}}]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_reference(dtype):
    """Two updates from identical parameters, gradients and state (the
    first clipped, the second not)."""
    jdt = jnp.dtype(dtype)
    cfg = OptConfig(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=5.0)
    jcfg = jax_optim.OptConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(dtype, 0))
    js = jax_optim.init_opt_state(jp)
    tp = _port(jp)
    ts = init_opt_state(tp)
    for i, gscale in enumerate((3.0, 0.1)):
        jg = jax.tree.map(lambda a: jnp.asarray(a * gscale, jdt),
                          _tree(dtype, i + 1))
        jp, js, jm = jax_optim.adamw_update(jcfg, jp, jg, js)
        tp, ts, tm = adamw_update(cfg, tp, _port(jg), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for name in ("m", "v"):
            _close(ts[name], _port(js[name]), "float32")
        _close(tp, _port(jp), dtype)


def _port(jtree):
    return tree_map(lambda a: to_tensor(np.asarray(a), "cpu"), jtree)


def _close(got, want, dtype):
    for (path, a), (_, b) in zip(flatten_with_path(got),
                                 flatten_with_path(want)):
        assert a.dtype == b.dtype, path
        if dtype == "float32":    # 1e-6, floored at 1e-6 of the leaf's max
            torch.testing.assert_close(
                a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()),
                msg=str(path))
        else:   # equal, or one bf16 ulp apart
            ulp = torch.finfo(torch.bfloat16).eps * b.float().abs().clamp(
                min=torch.finfo(torch.bfloat16).tiny)
            diff = (a.float() - b.float()).abs()
            assert bool((diff <= ulp).all()), (path, float(diff.max()))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_decay_mask_picks_the_reference_leaves(arch):
    """Per leaf name, the port's mask over the converted tree decays
    exactly the leaves the reference's decays."""
    jparams = jax.eval_shape(
        lambda: jax_init_params(jax_get_config(arch).reduced(),
                                jax.random.PRNGKey(0)))
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        want.setdefault(_name(path), set()).add(jax_optim._decay_mask(path))
    leaves = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jparams)
    got = {}
    for path, _ in flatten_with_path(convert_params(leaves, device="cpu")):
        name = next((p for p in reversed(path) if isinstance(p, str)), "")
        got.setdefault(name, set()).add(_decay_mask(path))
    assert got == want
    assert any(True in v for v in got.values())
    assert any(False in v for v in got.values())


def _name(path):
    for p in reversed(path):
        if hasattr(p, "key"):
            return str(p.key)
    return ""
