"""The port's PagedKVCache against the reference's allocator.

One scripted sequence of alloc / free / acquire / register / match /
fork operations runs on both caches; after every operation the
refcounts, the fresh stack, the parked list, the prefix index, every
return value and the ``check_invariants`` verdict must be identical.
Holdings emptied by ``alloc(0)`` are skipped before forking (the
reference's own harness indexes them, see ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serve.paged_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.configs import get_config
from repro_torch.serve import PagedKVCache, default_page_size, prefix_digests
from repro.serve.paged_cache import prefix_digests as jax_prefix_digests

JCFG = jax_get_config("qwen2-7b").reduced()
CFG = get_config("qwen2-7b").reduced()
PAGE = 128
_KINDS = ("alloc", "free", "acquire", "register", "match", "fork")


def _state(pc):
    return (list(pc._refs), list(pc._fresh), list(pc._parked),
            dict(pc._index), pc.free_blocks, pc.used_blocks,
            pc.cached_blocks)


def _verdict(pc):
    try:
        pc.check_invariants()
    except AssertionError as e:
        return str(e)
    return None


def _script(seed, n_ops):
    rng = np.random.default_rng(seed)
    ops = [(_KINDS[int(rng.integers(0, len(_KINDS)))],
            int(rng.integers(0, 8))) for _ in range(n_ops)]
    toks = rng.integers(0, 97, (n_ops, 4 * PAGE)).astype(np.int32)
    return ops, toks


def _replay(pc, ops, toks):
    """Apply the script; return one record per op."""
    held, log = [], []
    for step, (kind, arg) in enumerate(ops):
        out = None
        if kind == "alloc":
            out = pc.alloc(arg % 4)
            if out:
                held.append(out)
        elif kind == "free" and held:
            pc.free(held.pop(arg % len(held)))
        elif kind == "acquire" and held:
            ids = held[arg % len(held)]
            pc.acquire(ids)
            held.append(list(ids))
        elif kind == "register" and held:
            ids = held[arg % len(held)]
            # every other registration reuses an earlier prompt, so
            # duplicate digests and prefix matches both occur
            t = toks[step if step % 2 else max(0, step - 2)]
            pc.register_prefix(t[:len(ids) * PAGE], ids)
        elif kind == "match":
            out = pc.match_prefix(toks[max(0, step - 1 - arg)])
        elif kind == "fork" and held and pc.free_blocks >= 1:
            ids = held[arg % len(held)]
            b = ids[arg % len(ids)]
            out = pc.fork(b)
            ids[ids.index(b)] = out
        log.append((kind, out, _state(pc), _verdict(pc)))
    for ids in held:
        pc.free(ids)
    log.append(("drain", None, _state(pc), _verdict(pc)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_ops_match_reference(seed):
    ops, toks = _script(seed, 250)
    ref = _replay(JaxPagedKVCache(JCFG, n_blocks=9, page=PAGE), ops, toks)
    got = _replay(PagedKVCache(CFG, n_blocks=9, page=PAGE, device="cpu"),
                  ops, toks)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a == b, f"op {i} {ops[i] if i < len(ops) else 'drain'}"
    assert {k for k, _ in ops} == set(_KINDS)
    # the script reached prefix hits and parked (revivable) blocks
    assert any(k == "match" and out for k, out, _, _ in got)
    assert any(state[2] for _, _, state, _ in got)
    assert got[-1][2][4] == 8                     # everything reclaimed


def test_corruption_verdicts_match_reference():
    """A seeded corruption (a live block pushed onto the fresh stack) is
    reported with the same message on both sides."""
    verdicts = []
    for pc in (JaxPagedKVCache(JCFG, n_blocks=5, page=PAGE),
               PagedKVCache(CFG, n_blocks=5, page=PAGE, device="cpu")):
        ids = pc.alloc(2)
        pc._fresh.append(ids[0])
        verdicts.append(_verdict(pc))
    assert verdicts[0] is not None and verdicts[0] == verdicts[1]


def test_prefix_digests_match_reference():
    toks = np.random.default_rng(3).integers(0, 500, 300).astype(np.int32)
    assert prefix_digests(toks, 64) == jax_prefix_digests(toks, 64)


def test_fork_copies_every_layer_row_block():
    pc = PagedKVCache(CFG, n_blocks=4, page=PAGE, device="cpu")
    b = pc.alloc(1)[0]
    pc.acquire([b])
    for pool in pc.pools.values():
        pool[:, b] = torch.randn(pool[:, b].shape).to(pool.dtype)
    dst = pc.fork(b)
    assert dst != b and pc.ref_count(b) == 1 and pc.ref_count(dst) == 1
    for pool in pc.pools.values():
        assert torch.equal(pool[:, dst], pool[:, b])
    pc.check_invariants()


def test_pool_layout():
    pc = PagedKVCache(CFG, n_blocks=6, page=64, device="cpu")
    shp = (CFG.n_layers, 6, 64, CFG.n_kv_heads, CFG.hd)
    assert pc.pools["k"].shape == shp and pc.pools["v"].shape == shp
    assert pc.pools["k"].dtype == torch.bfloat16
    assert pc.capacity == 5


@pytest.mark.parametrize("page", [16, 64, 128, 512])
def test_valid_pages_accepted(page):
    assert PagedKVCache(CFG, n_blocks=2, page=page, device="cpu").page == page


@pytest.mark.parametrize("page", [0, 8, 100, 1024, 64.5, True])
def test_invalid_page_raises(page):
    with pytest.raises(ValueError, match="multiple of 16 rows"):
        PagedKVCache(CFG, n_blocks=2, page=page, device="cpu")


def test_default_page_size_hopper_rule():
    assert default_page_size(CFG) == 64
    assert default_page_size(CFG, cap=512) == 64
    assert default_page_size(CFG, cap=20) == 32
    assert default_page_size(CFG, cap=1) == 16


def test_cache_rejects_non_attention_layers():
    import dataclasses
    cfg = dataclasses.replace(CFG, family="ssm")
    with pytest.raises(NotImplementedError, match="only plain GQA"):
        PagedKVCache(cfg, n_blocks=3, page=64, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_cache_rejects_the_ssm_and_hybrid_configs(arch):
    """The real configs, as the reference's cache rejects them: their SSM
    layers keep an O(1) state and are served by the sync engine."""
    with pytest.raises(NotImplementedError, match="only plain GQA.*ssm"):
        PagedKVCache(get_config(arch), n_blocks=3, page=64, device="cpu")
    with pytest.raises(NotImplementedError, match="only plain GQA"):
        JaxPagedKVCache(jax_get_config(arch).reduced(), n_blocks=3,
                        page=PAGE)
