"""The MoE models on a mesh: reduced f32 ``qwen3-moe-235b-a22b``,
``jamba-v0.1-52b`` (MoE and SSM, cut to one 4-layer period: three SSM
layers, one attention layer, MoE on two) and ``deepseek-v2-lite-16b``
(MoE, MLA and shared experts).

One group of 4 gloo ranks (``tests/_torch_dist.py``, scenario
``sharded_moe``) runs each model's ``forward``, ``prefill`` and
``decode_step`` on a (2, 2) ("data", "model") mesh, the parameters
placed by ``param_axes_rule``, with the kernels off and on (on the CPU
the sharded kernel bodies run the plain versions), beside the same steps
unsharded on every rank (jamba in a second group beside the first).
A one-rank group runs qwen3-moe on the (1, 1) mesh, where every
placement is ``Replicate()`` (the card's mesh).

Each sharded result is held to the port's unsharded run: the largest
difference at most 1e-5 of the largest logit (f32; a split sum's
summation order).  The mesh-free tests (``test_torch_model.py``,
``test_torch_mla.py``) hold the unsharded port to the reference; here
the reference's own unsharded qwen3-moe ``forward`` is held too, at
``test_torch_model.py``'s rtol 1e-5.  The reference's sharded MoE path
does not run on this tree's jax, so its unsharded path is the oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import finish, start
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models.model import forward as jax_forward
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.models import init_params

MAX_LEN, POS = 32, 16
ARCHS = {"qwen3-moe-235b-a22b": {}, "jamba-v0.1-52b": {"n_layers": 4},
         "deepseek-v2-lite-16b": {}}
STEPS = ("forward", "prefill", "decode")
REFERENCE_HELD = "qwen3-moe-235b-a22b"


def _cfgs(arch):
    """(reference config, port config): reduced, f32, cut as ARCHS says."""
    kw = dict(ARCHS[arch], dtype="float32")
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _inputs(tmp, archs, kernels):
    """The ranks' inputs: qwen3-moe with the reference's weights
    (converted), the others with the port's own from the seed."""
    jparams, params = {}, {}
    for arch in archs:
        jcfg, cfg = _cfgs(arch)
        if arch == REFERENCE_HELD:
            jparams[arch] = jax_init_params(jcfg, jax.random.PRNGKey(0))
            params[arch] = convert_params(
                jax.tree.map(np.asarray, jparams[arch]), device="cpu")
        else:
            params[arch] = init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    tok = np.random.default_rng(3).integers(0, 512, (4, 16)).astype(np.int32)
    torch.save({"archs": {a: (_cfgs(a)[1], params[a]) for a in archs},
                "kernels": kernels, "tokens": torch.from_numpy(tok).long(),
                "max_len": MAX_LEN, "pos": POS}, tmp / "in.pt")
    return jparams, tok


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Two (2, 2) groups (jamba alone: DTensor's first dispatch of its
    SSM ops costs as much as the other two models together) and the
    one-rank group, run side by side; the (2, 2) groups' outputs merged
    rank by rank."""
    jparams, tok = {}, None
    groups = {}
    for name, archs, kernels, world in (       # jamba's needs no jax
            ("2x2 jamba", ["jamba-v0.1-52b"], (False, True), 4),
            ("2x2", [REFERENCE_HELD, "deepseek-v2-lite-16b"], (False, True),
             4),
            ("1x1", [REFERENCE_HELD], (True,), 1)):
        tmp = tmp_path_factory.mktemp("sharded_moe")
        jp, tok = _inputs(tmp, archs, kernels)
        jparams.update(jp)
        groups[name] = start("sharded_moe", world, tmp)
    runs = {k: finish(g) for k, g in groups.items()}
    for rank, out in enumerate(runs.pop("2x2 jamba")):
        runs["2x2"][rank].update(out)
    return runs, jparams, tok


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("kernels_on", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_moe_model_matches_unsharded(mesh_runs, arch, kernels_on):
    runs, *_ = mesh_runs
    for rank, out in enumerate(runs["2x2"]):
        res = out[(arch, kernels_on)]
        for step in STEPS:
            got, want = res["sharded"][step], res["plain"][step]
            assert got.shape == want.shape and torch.isfinite(got).all()
            assert _rel(got, want) <= 1e-5, (rank, step, _rel(got, want))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_moe_ran_the_sharded_kernels(mesh_runs, arch):
    runs, *_ = mesh_runs
    _, cfg = _cfgs(arch)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    for out in runs["2x2"]:
        assert not any(out[(arch, False)]["sharded"]["bodies"].values())
        bodies = out[(arch, True)]["sharded"]["bodies"]
        # three expert products a MoE layer a call: forward, prefill, decode
        assert bodies["moe_gmm"] == 3 * 3 * n_moe, bodies
        assert (bodies["mamba2_ssd"] > 0) == (cfg.ssm is not None), bodies
        assert not any(out[(arch, True)]["plain"]["bodies"].values())


def test_moe_on_the_one_rank_mesh_matches_unsharded(mesh_runs):
    runs, *_ = mesh_runs
    (out,) = runs["1x1"]
    res = out[(REFERENCE_HELD, True)]
    for step in STEPS:
        assert _rel(res["sharded"][step], res["plain"][step]) <= 1e-5, step
    assert res["sharded"]["bodies"]["moe_gmm"] > 0


def test_sharded_qwen3_moe_forward_matches_the_reference(mesh_runs):
    runs, jparams, tok = mesh_runs
    arch = REFERENCE_HELD
    jcfg, _ = _cfgs(arch)
    ref, _ = jax_forward(jcfg, jparams[arch], {"tokens": jnp.asarray(tok)})
    ref = np.asarray(ref, np.float32)
    for out in runs["2x2"]:
        for kernels_on in (False, True):
            got = out[(arch, kernels_on)]["sharded"]["forward"].numpy()
            np.testing.assert_allclose(
                got, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()))
