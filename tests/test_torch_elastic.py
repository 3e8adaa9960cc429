"""Elastic restore: a checkpoint saved by one process (the reference's
reduced qwen2-7b weights, converted, saved by the port) restores onto an
8-rank (4, 2) ("data", "model") gloo mesh through
``restore(sharding_fn=)``, each leaf laid out by ``param_axes_rule``
(the twin of ``tests/test_elastic.py``).  Every rank holds its block of
the expected shape, some leaf splits over all 8 ranks, and every leaf's
global value is the one saved, bit for bit.
"""

import dataclasses

import jax
import numpy as np

from _torch_dist import launch
from _torch_train import to_port
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.train.checkpoint import save
from repro_torch.tree import flatten_with_path


def test_save_one_process_restore_eight_ranks(tmp_path):
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                               dtype="float32")
    params = to_port(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    save(tmp_path / "ckpt", 42, params)
    outs = launch("elastic", 8, tmp_path)
    want = {"::".join(p if isinstance(p, str) else f"#{p}" for p in path):
            leaf for path, leaf in flatten_with_path(params)}
    split_eight = False
    for out in outs:
        assert out["step"] == 42
        assert out["full"].keys() == want.keys()
        for key, leaf in want.items():
            got = out["full"][key]
            assert got.dtype == leaf.dtype
            np.testing.assert_array_equal(got.numpy(), leaf.numpy())
            local, shard_dims = out["local"][key]     # None: replicated
            parts = [1] * leaf.dim()
            for size, d in zip((4, 2), shard_dims):
                if d is not None:
                    parts[d] *= size
            assert local == tuple(n // p for n, p in zip(leaf.shape, parts))
            split_eight |= np.prod(parts) == 8
    assert split_eight
