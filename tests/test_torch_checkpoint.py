"""The port's checkpoints: the twins of ``tests/test_checkpoint.py``
(but the elastic re-shard, which belongs to the parallel slice), bf16
and 0-d leaves, the temporary directory, and the on-disk format read
bit for bit across packages in both directions."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro.train import checkpoint as jax_ckpt
from repro_torch.train.checkpoint import (Checkpointer, latest_step, restore,
                                          save)
from repro_torch.tree import flatten_with_path, leaves, tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((8, 16), generator=g).to(
                           torch.bfloat16),
                       "b": torch.zeros((16,), dtype=torch.float32)},
            "step_count": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.ones((3,)), {"m": torch.arange(5)}]}


def _assert_same(got, want):
    g, w = list(flatten_with_path(got)), list(flatten_with_path(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def test_roundtrip(tmp_path):
    t = _tree()
    save(tmp_path, 10, t)
    restored, step = restore(tmp_path, t)
    assert step == 10
    _assert_same(restored, t)


def test_bf16_and_0d_leaves_roundtrip_bit_for_bit(tmp_path):
    bits = torch.from_numpy(np.array(
        [0x0001, 0x7F80, 0xFF80, 0x7FC1, 0x8000, 0x3F81],
        np.uint16).view(np.int16))
    t = {"bf16": bits.view(torch.bfloat16),           # denormal, inf, nan
         "scalar_bf16": torch.tensor(1.5, dtype=torch.bfloat16),
         "scalar_f32": torch.tensor(-2.25),
         "step": torch.tensor(3, dtype=torch.int32),
         "flag": torch.tensor([True, False])}
    d = save(tmp_path, 1, t)
    manifest = json.loads((d / "meta.json").read_text())["manifest"]
    assert manifest["scalar_f32"]["shape"] == []
    assert np.load(d / manifest["scalar_f32"]["file"]).shape == (1,)
    assert manifest["bf16"]["dtype"] == "bfloat16"
    restored, _ = restore(tmp_path, t)
    for k in t:
        assert restored[k].dtype == t[k].dtype
        assert restored[k].shape == t[k].shape
        assert torch.equal(_int_bits(restored[k]), _int_bits(t[k])), k


def _int_bits(t):
    """A tensor's bits as signed integers (NaN payloads compare)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return t.reshape(-1).view(ints[t.element_size()])


def test_latest_step_and_gc(tmp_path):
    assert latest_step(tmp_path) is None
    ck = Checkpointer(tmp_path, every=2, keep=2)
    t = _tree()
    for s in range(1, 9):
        ck.maybe_save(s, t)
    ck.wait()
    assert latest_step(tmp_path) == 8
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert len(steps) <= 2  # gc kept only the last `keep`


def test_tmp_directory_is_invisible(tmp_path):
    save(tmp_path, 4, _tree())
    (tmp_path / ".tmp_step_9").mkdir()       # a save cut off before its rename
    assert latest_step(tmp_path) == 4
    _, step = restore(tmp_path, _tree())
    assert step == 4


def test_async_save_copies_before_returning(tmp_path):
    """The tree is copied to the host on the calling thread: changing it
    after maybe_save does not reach the checkpoint."""
    t = _tree()
    want = tree_map(lambda x: x.clone(), t)
    ck = Checkpointer(tmp_path, every=1)
    assert ck.maybe_save(1, t)
    for x in leaves(t):
        x.zero_()
    ck.wait()
    restored, _ = restore(tmp_path, t)
    _assert_same(restored, want)


def test_restore_into_fresh_tensors(tmp_path):
    """Restore into a tree that only carries shapes and dtypes (a fresh
    boot: uninitialised tensors)."""
    t = _tree()
    save(tmp_path, 3, t)
    like = tree_map(torch.empty_like, t)
    restored, step = restore(tmp_path, like)
    _assert_same(restored, t)


def test_restore_casts_to_the_like_dtype(tmp_path):
    t = _tree()
    save(tmp_path, 2, t)
    like = tree_map(lambda x: x.float() if x.is_floating_point() else x, t)
    restored, _ = restore(tmp_path, like)
    assert restored["layers"]["w"].dtype == torch.float32
    assert torch.equal(restored["layers"]["w"], t["layers"]["w"].float())


def test_restore_shape_mismatch_raises(tmp_path):
    t = _tree()
    save(tmp_path, 1, t)
    bad = dict(t)
    bad["layers"] = {"w": torch.zeros((9, 16), dtype=torch.bfloat16),
                     "b": t["layers"]["b"]}
    with pytest.raises(ValueError, match="shape"):
        restore(tmp_path, bad)


def test_restore_missing_key_and_no_checkpoint_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(tmp_path, _tree())
    save(tmp_path, 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="missing keys"):
        restore(tmp_path, {"a": torch.ones(2), "b": torch.ones(2)})


def _format_trees():
    """The same bf16, f32 and int32 leaves (a 0-d one and a list too) as a
    reference pytree and as a port tree."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    ids = rng.integers(-9, 9, (4,)).astype(np.int32)
    jtree = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b),
             "opt": {"step": jnp.int32(11), "ids": [jnp.asarray(ids)]}}
    ttree = {"w": torch.from_numpy(w).to(torch.bfloat16),
             "b": torch.from_numpy(b),
             "opt": {"step": torch.tensor(11, dtype=torch.int32),
                     "ids": [torch.from_numpy(ids)]}}
    return jtree, ttree


def _bits(x):
    a = np.asarray(x)
    return a.view(np.dtype(f"uint{8 * a.itemsize}")).reshape(a.shape)


def test_port_reads_the_reference_format(tmp_path):
    jtree, ttree = _format_trees()
    jax_ckpt.save(tmp_path, 5, jtree)
    restored, step = restore(tmp_path, tree_map(torch.empty_like, ttree))
    assert step == 5
    _assert_same(restored, ttree)


def test_reference_reads_the_port_format(tmp_path):
    jtree, ttree = _format_trees()
    save(tmp_path, 6, ttree)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jtree)
    restored, step = jax_ckpt.restore(tmp_path, like)
    assert step == 6
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_manifests_agree(tmp_path):
    """The two packages write the same keys, shapes and dtype names."""
    jtree, ttree = _format_trees()
    jd = jax_ckpt.save(tmp_path / "ref", 1, jtree)
    td = save(tmp_path / "port", 1, ttree)

    def entries(d):
        m = json.loads((d / "meta.json").read_text())["manifest"]
        return {k: (v["shape"], v["dtype"], np.load(d / v["file"]).dtype.str,
                    np.load(d / v["file"]).shape) for k, v in m.items()}
    assert entries(jd) == entries(td)
