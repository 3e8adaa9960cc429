"""Logical-axis sharding rules against the reference.

Every case of ``tests/test_sharding.py`` runs against
``repro_torch.parallel.api`` (the divisibility guard, "first wins", the
grouped-divisibility rule of ``shard_assignment``), with the same
duck-typed mesh (``.shape`` only, no devices and no process group).  Then
``logical_to_spec`` of every parameter and decode-cache leaf of all ten
full-width configs, on the (16, 16) and (2, 16, 16) production meshes,
must equal the reference's leaf for leaf: the reference's side runs
through ``jax.eval_shape`` of its ``init_params``/``init_cache`` and its
own rules; the port's on meta tensors.  The reference stacks each layer
slot with a leading period dim, always unsharded, which the port's
per-layer leaves do not have: that leading ``None`` is checked and
dropped.
"""

import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import cache_axes_rule as jax_cache_rule
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params
from repro.models.model import param_axes_rule as jax_param_rule
from repro.parallel.api import logical_to_spec as jax_logical_to_spec
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import model as M
from repro_torch.models.blocks import schedule
from repro_torch.parallel.api import (AxisSpec, PartitionSpec as P,
                                      current_mesh, local_shapes,
                                      logical_to_spec, named_sharding,
                                      set_mesh, shard, shard_assignment,
                                      to_placements)
from repro_torch.perf.torch_graph import meta_cache, meta_params
from repro_torch.tree import flatten_with_path


class _FakeMesh:
    """Duck-typed mesh exposing .shape for guard tests."""
    def __init__(self, shape):
        self.shape = shape


def _spec(shape, logical, mesh_shape):
    return logical_to_spec(shape, logical, _FakeMesh(mesh_shape))


# ---------------------------------------------------------------------------
# tests/test_sharding.py, case for case
# ---------------------------------------------------------------------------

def test_divisible_dims_shard():
    assert _spec((64000, 7168), ("vocab", "fsdp"),
                 {"data": 16, "model": 16}) == P("model", "data")


def test_indivisible_dims_drop():
    assert _spec((51865, 512), ("vocab", "fsdp"),
                 {"data": 16, "model": 16}) == P(None, "data")


def test_axis_used_once():
    assert _spec((256, 4096, 16), ("batch", "seq", "fsdp"),
                 {"pod": 2, "data": 16, "model": 16}) \
        == P(("pod", "data"), "model", None)


def test_batch_multi_axis_partial():
    assert _spec((8, 10), ("batch", None), {"pod": 2, "data": 16}) \
        == P("pod", None)


def test_kv_seq_uses_model_then_data():
    assert _spec((1, 524288, 8, 128), ("batch", "kv_seq", None, None),
                 {"data": 16, "model": 16}) == P(None, ("model", "data"), None,
                                                 None)


def test_missing_axis_ignored():
    assert _spec((128, 128), ("batch", None), {"model": 4}) == P(None, None)


def test_no_mesh_is_noop():
    assert current_mesh() is None
    x = torch.ones((4, 4))
    assert shard(x, "batch", None) is x


def test_set_mesh_plumbing():
    mesh = _FakeMesh({"data": 1, "model": 1})
    with set_mesh(mesh):
        assert current_mesh() is mesh
        assert logical_to_spec((16, 16), ("fsdp", "tp")) == P("data", "model")
        x = torch.ones(4)
        assert shard(x, "batch") is x        # a plain tensor stays as it is
    assert current_mesh() is None


def test_custom_rules():
    rules = AxisSpec((("batch", ("x",)),))
    assert logical_to_spec((8,), ("batch",), _FakeMesh({"x": 4}),
                           rules) == P("x")
    assert logical_to_spec((8,), ("unknown",), _FakeMesh({"x": 4}),
                           rules) == P(None)


def test_rank_mismatch_raises_descriptive_valueerror():
    with pytest.raises(ValueError) as err:
        logical_to_spec((4, 8), ("batch",), _FakeMesh({"data": 2}))
    msg = str(err.value)
    assert "(4, 8)" in msg and "('batch',)" in msg
    with pytest.raises(ValueError, match="same rank"):
        logical_to_spec((4, 8), ("batch",))


_MESH = _FakeMesh({"data": 2, "model": 4})
_ATTN = {"B": 4, "S": 128, "T": 128, "H": 8, "KV": 4, "hd": 32}
_ATTN_LOGICAL = {"B": "batch", "H": "heads", "KV": "heads"}


def test_grouped_dims_co_shard():
    asn = shard_assignment(_ATTN, _ATTN_LOGICAL, _MESH)
    assert asn.counts["H"] == 4 and asn.counts["KV"] == 4
    assert asn.counts["B"] == 2
    assert asn.axes_of["H"] == ("model",) == asn.axes_of["KV"]
    assert local_shapes(_ATTN, _ATTN_LOGICAL, _MESH) == {
        "B": 2, "S": 128, "T": 128, "H": 2, "KV": 1, "hd": 32}


def test_group_member_indivisible_blocks_the_axis():
    asn = shard_assignment(dict(_ATTN, KV=2), _ATTN_LOGICAL, _MESH)
    assert asn.counts["H"] == 1 and asn.counts["KV"] == 1
    assert "H" not in asn.axes_of


def test_size_one_group_member_broadcasts():
    ssd = {"B": 4, "S": 64, "nh": 8, "hd": 16, "ds": 16, "G": 1}
    logical = {"B": "batch", "nh": "heads", "G": "heads"}
    asn = shard_assignment(ssd, logical, _MESH)
    assert asn.counts["nh"] == 4 and asn.counts["G"] == 1
    assert asn.spec("B", None, "G", None) == P("data", None, None, None)


def test_assignment_axis_used_once():
    asn = shard_assignment({"E": 8, "H": 8}, {"E": "expert", "H": "heads"},
                           _MESH)
    assert asn.counts["E"] == 4 and asn.counts["H"] == 1


def test_assignment_spec_matches_counts():
    asn = shard_assignment(_ATTN, _ATTN_LOGICAL, _MESH)
    assert asn.spec("B", None, "H", None) == P("data", None, "model", None)
    assert asn.spec("B", None, "KV", None) == P("data", None, "model", None)
    assert asn.spec("B") == P("data")


def test_local_shapes_without_mesh_is_identity():
    assert current_mesh() is None
    assert local_shapes(_ATTN, _ATTN_LOGICAL) == _ATTN


def test_assignment_unknown_dim_raises():
    with pytest.raises(ValueError, match="names dims"):
        shard_assignment({"B": 4}, {"B": "batch", "G": "heads"}, _MESH)


# ---------------------------------------------------------------------------
# the port's own: placements, and the specs of the kernel contracts
# ---------------------------------------------------------------------------

def test_placements_shard_each_named_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh({"data": 16, "model": 16})
    assert to_placements(P("model", "data"), mesh) == [Shard(1), Shard(0)]
    # a dim on two axes is split over both (in mesh-dim order)
    assert to_placements(P(None, ("model", "data")), mesh) == [Shard(1),
                                                               Shard(1)]
    assert named_sharding((51865, 512), ("vocab", "fsdp"), mesh) == [
        Shard(1), Replicate()]
    assert named_sharding((4,), ("batch",), None) is None


def test_partition_spec_equals_the_references():
    """The port's spec is the reference's entry for entry."""
    mesh = {"pod": 2, "data": 16, "model": 16}
    for shape, logical in (((256, 4096, 16), ("batch", "seq", "fsdp")),
                           ((1, 524288, 8, 128),
                            ("batch", "kv_seq", None, None)),
                           ((8, 10), ("batch", None))):
        ours = logical_to_spec(shape, logical, _FakeMesh(mesh))
        theirs = jax_logical_to_spec(shape, logical, _FakeMesh(mesh))
        assert tuple(ours) == tuple(theirs)


# ---------------------------------------------------------------------------
# every parameter and cache leaf of the ten full-width configs
# ---------------------------------------------------------------------------

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _key(path):
    return tuple(p.key if hasattr(p, "key") else p.idx for p in path)


def _port_paths(cfg, ref_path, cache):
    """The port's leaf paths for one reference leaf: a stacked slot leaf
    becomes one leaf a period (dropping the period dim)."""
    first_k, period, n_periods = schedule(cfg)
    head = () if cache else ("layers",)
    if ref_path[0] == "layers0":
        return [head + (ref_path[1],) + ref_path[2:]], 0
    if ref_path[0] == "layers":
        s = ref_path[1]
        return [head + (first_k + p * period + s,) + ref_path[2:]
                for p in range(n_periods)], 1
    if ref_path[:2] == ("encoder", "layers"):
        return [("encoder", "layers", i) + ref_path[3:]
                for i in range(cfg.encoder.n_layers)], 1
    return [ref_path], 0


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jcfg = jax_get_config(arch)
    cfg = dataclasses.replace(get_config(arch), use_kernels=False)
    jp = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    jc = jax.eval_shape(lambda: jax_init_cache(jcfg, 128, 32768))
    return (jcfg, cfg, jp, jc, dict(flatten_with_path(meta_params(cfg))),
            dict(flatten_with_path(meta_cache(cfg, 128, 32768))))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_specs_equal_the_references(arch, mesh):
    _, cfg, jp, jc, params, cache = _trees(arch)
    fake = _FakeMesh(MESHES[mesh])
    for tree, port, jrule, rule, is_cache in (
            (jp, params, jax_param_rule, M.param_axes_rule, False),
            (jc, cache, jax_cache_rule, M.cache_axes_rule, True)):
        seen = set()
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            want = tuple(jax_logical_to_spec(leaf.shape, jrule(path, leaf),
                                             fake))
            paths, lead = _port_paths(cfg, _key(path), is_cache)
            assert want[:lead] == (None,) * lead
            for p in paths:
                t = port[p]
                assert tuple(t.shape) == tuple(leaf.shape)[lead:], p
                got = logical_to_spec(t.shape, rule(p, t), fake)
                assert tuple(got) == want[lead:], (p, got, want)
                seen.add(p)
        assert seen == set(port), sorted(set(port) - seen)[:5]


def _block_case(kernel):
    """(wrapper, operands) of ``kernel`` at small CPU shapes whose batch,
    heads and experts all divide a (2, 2) mesh."""
    from repro_torch import kernels
    g = torch.Generator().manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g)
    if kernel == "flash_attention":
        return (lambda *t: kernels.flash_attention(*t, causal=True),
                (randn(4, 24, 8, 32), randn(4, 24, 4, 32),
                 randn(4, 24, 4, 32)))
    if kernel == "decode_attention":
        return kernels.decode_attention, (
            randn(4, 8, 32), randn(4, 300, 4, 32), randn(4, 300, 4, 32),
            torch.tensor([300, 1, 200, 129], dtype=torch.int32))
    if kernel == "moe_gmm":
        return kernels.moe_gmm, (randn(8, 12, 32), randn(8, 32, 16))
    return kernels.mamba2_ssd, (
        randn(2, 40, 8, 16) * 0.5, torch.rand(2, 40, 8) + 0.05,
        -torch.rand(8) - 0.1, randn(2, 40, 1, 16) * 0.5,
        randn(2, 40, 1, 16) * 0.5)


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "moe_gmm", "mamba2_ssd"])
def test_local_blocks_reassemble_the_unsharded_call(kernel):
    """``kernels.sharded.on_local_blocks`` (the one-device check of a
    kernel on a mesh's local blocks) cuts each operand as the sharded
    path's placements do, and the blocks' outputs put back together
    equal the unsharded call (the plain versions here: each block's rows
    or heads are computed alone either way)."""
    from repro_torch.kernels.sharded import on_local_blocks
    fn, operands = _block_case(kernel)
    whole = fn(*operands)
    got, local = on_local_blocks(kernel, fn, operands,
                                 {"data": 2, "model": 2}, whole)
    assert len(local) == 1
    shapes = local.pop()
    for full, block in zip(operands, shapes):
        assert block != tuple(full.shape) or full.dim() == 1
    pairs = zip(got, whole) if isinstance(whole, tuple) else [(got, whole)]
    for g, w in pairs:
        assert g.shape == w.shape and not torch.isnan(g).any()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
