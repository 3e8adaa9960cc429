"""The sharded path on a 4-rank (2, 2) ("data", "model") gloo mesh.

One group of ranks (``tests/_torch_dist.py``, scenario ``sharded``) runs:

* the four kernels with a logical-axis contract on DTensor operands,
  which send them through their sharded wrappers (``local_map`` over the
  catalog's placements; on the CPU the per-shard body is the plain
  version) at ``tests/test_sharding_pallas.py``'s shapes, where heads,
  batch and experts really split;
* ``paged_decode_attention`` and ``mfma_gemm`` on DTensor operands,
  which must raise a ``ValueError`` naming the missing contract;
* reduced qwen2-7b (the reference's weights, converted) placed by
  ``param_axes_rule``: ``forward``, ``prefill`` and ``decode_step`` on both
  paths, and one train step;
* ``prefetch_to_device(sharding=...)``: each rank's block of every
  prefetched leaf against the block the reference's ``NamedSharding``
  gives its device.

Each sharded result is held to the port's unsharded run (the same code
on one rank: float32 atol 1e-5, the summation order of a split sum) and
to the reference's unsharded path: its Pallas kernels in interpret mode
at the kernel tests' tolerances, its model at ``test_torch_model.py``'s
rtol 1e-5, its train step's metrics at ``test_torch_train_step.py``'s
rtol 1e-4.  The train step's parameters are held by their update
(p1 - p0), whose size is about lr = 1e-3 an element, to atol 3e-4, and
every leaf must move; the AdamW moments, which are linear (m) and
quadratic (v) in the gradient, to rtol 1e-4 with atol 1e-5 of the
leaf's largest moment (an element near 0 carries the split sums'
cancellation, as the model steps' atol does).  The reference's own sharded
path does not run on this tree's jax (ROADMAP queue 3), so the twin is
held to its unsharded path, by global values, never by which rows a
rank holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import launch
from _torch_train import to_port
from repro.configs import get_config as jax_get_config
from repro.kernels import ops
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import prefill as jax_prefill
from repro.train.optim import OptConfig as JaxOptConfig
from repro.train.optim import init_opt_state as jax_init_opt_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.tree import flatten_with_path

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
MAX_LEN, POS = 32, 16
JCFG = dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                           dtype="float32")


def _rng(seed):
    return np.random.default_rng(seed)


def _attn(B, S, T, H, KV, hd, seed):
    r = _rng(seed)
    return (r.standard_normal((B, S, H, hd)).astype(np.float32),
            r.standard_normal((B, T, KV, hd)).astype(np.float32),
            r.standard_normal((B, T, KV, hd)).astype(np.float32))


def _ssd(B, S, nh, hd, G, ds, seed):
    r = _rng(seed)
    return (r.standard_normal((B, S, nh, hd)).astype(np.float32),
            np.log1p(np.exp(r.standard_normal((B, S, nh)))).astype(
                np.float32) * 0.5,
            -np.exp(r.standard_normal(nh)).astype(np.float32),
            r.standard_normal((B, S, G, ds)).astype(np.float32) * 0.5,
            r.standard_normal((B, S, G, ds)).astype(np.float32) * 0.5)


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


# name -> (port wrapper, numpy operands, torch dtype of q/x, kwargs,
#          the reference's Pallas output, tolerance (atol, rtol))
def _kernel_cases():
    cases = {}
    for S, dt in ((128, "float32"), (100, "float32"), (128, "bfloat16")):
        arrs = _attn(4, S, S, 8, 4, 32, seed=S)
        jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
        ref = ops.flash_attention(*(jnp.asarray(a, jdt) for a in arrs),
                                  causal=True, block_q=128, block_kv=128,
                                  pad=True, interpret=True)
        tol = (1e-2, 2.0 ** -7) if dt == "bfloat16" else (1e-4, 0.0)
        tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
        cases[f"flash_s{S}_{dt}"] = ("flash_attention", _t(arrs, tdt),
                                     {"causal": True}, ref, tol)
    arrs = _attn(4, 1, 128, 8, 4, 32, seed=5)
    q = arrs[0][:, 0]
    for name, kv_len in (("decode_scalar", 38),
                         ("decode_per_request",
                          np.array([38, 128, 1, 77], np.int32))):
        ref = ops.decode_attention(
            jnp.asarray(q), jnp.asarray(arrs[1]), jnp.asarray(arrs[2]),
            jnp.asarray(kv_len, jnp.int32), block_kv=128, pad=True,
            interpret=True)
        lens = kv_len if isinstance(kv_len, int) else torch.from_numpy(
            kv_len)
        cases[name] = ("decode_attention",
                       _t([q, arrs[1], arrs[2]]) + [lens], {}, ref,
                       (1e-5, 0.0))
    for S in (64, 52):
        arrs = _ssd(4, S, 8, 16, 1, 16, seed=S)
        y, h = ops.mamba2_ssd(*(jnp.asarray(a) for a in arrs), pad=True)
        cases[f"ssd_s{S}"] = ("mamba2_ssd", _t(arrs), {}, (y, h),
                              (2e-3, 2e-3))
    r = _rng(11)
    x = r.standard_normal((8, 16, 128)).astype(np.float32)
    w = r.standard_normal((8, 128, 64)).astype(np.float32)
    ref = ops.moe_gmm(jnp.asarray(x), jnp.asarray(w), pad=True,
                      interpret=True)
    cases["moe_gmm"] = ("moe_gmm", _t([x, w]), {}, ref, (1e-4, 1e-5))
    return cases


CASES = _kernel_cases()


# prefetch_to_device(sharding=...): two batches of three leaves, laid out
# by a per-leaf rule (PartitionSpec entries; None: a plain tensor) and by
# one (mesh, placements) pair for every leaf
_B = _rng(21)
PREFETCH = {
    "batches": [{"tokens": _B.integers(0, 500, (8, 6)).astype(np.int32),
                 "labels": _B.integers(0, 500, (8, 6)).astype(np.int32),
                 "mask": _B.random((8, 6)).astype(np.float32)}
                for _ in range(2)],
    "specs": {"tokens": ("data", None), "labels": (("data", "model"), None),
              "mask": None},
    "pair": (None, "model")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    tok = _rng(3).integers(0, JCFG.vocab_size, (4, 16)).astype(np.int32)
    lab = _rng(4).integers(0, JCFG.vocab_size, (4, 16)).astype(np.int32)
    torch.save({
        "kernels": {k: (fn, args, kw) for k, (fn, args, kw, _, _)
                    in CASES.items()},
        "refusals": {
            "paged_decode_attention": (
                torch.zeros(2, 4, 32), torch.zeros(3, 16, 2, 32),
                torch.zeros(3, 16, 2, 32), torch.zeros(2, 1, dtype=torch.int32),
                torch.ones(2, dtype=torch.int32)),
            "mfma_gemm": (torch.zeros(8, 8), torch.zeros(8, 8),
                          torch.zeros(8, 8))},
        "params": jax.tree.map(np.asarray, jparams),
        "tokens": torch.from_numpy(tok).long(), "max_len": MAX_LEN,
        "pos": POS,
        "batch": {"tokens": torch.from_numpy(tok).long(),
                  "labels": torch.from_numpy(lab).long()},
        "opt": OPT, "prefetch": PREFETCH},
        tmp / "in.pt")
    return launch("sharded", 4, tmp), jparams, tok, lab


def _close(got, want, atol, rtol=0.0):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_kernel_matches_plain_and_pallas(ranks, name):
    outs, *_ = ranks
    fn, _, _, ref, (atol, rtol) = CASES[name]
    for r, out in enumerate(outs):
        got = out["kernels"][name]
        # every rank ran one shard body of its own
        assert got["bodies"] == 1, (r, got["bodies"])
        pairs = zip(got["sharded"], got["plain"], ref) \
            if isinstance(got["sharded"], tuple) \
            else [(got["sharded"], got["plain"], ref)]
        for sharded, plain, pallas in pairs:
            _close(sharded, plain, atol=1e-5 if sharded.dtype
                   == torch.float32 else 1e-2, rtol=rtol)
            _close(sharded, pallas, atol=atol, rtol=rtol)


@pytest.mark.parametrize("kernel", ["paged_decode_attention", "mfma_gemm"])
def test_kernels_without_contract_raise_under_a_mesh(ranks, kernel):
    outs, *_ = ranks
    msg = outs[0]["refusals"][kernel]
    assert kernel in msg and "no logical-axis contract" in msg


@pytest.fixture(scope="module")
def reference_steps(ranks):
    _, jparams, tok, _ = ranks
    logits, _ = jax_forward(JCFG, jparams, {"tokens": jnp.asarray(tok)})
    pl, cache = jax_prefill(JCFG, jparams, {"tokens": jnp.asarray(tok)},
                            MAX_LEN)
    dl, _ = jax_decode_step(JCFG, jparams, cache, jnp.asarray(tok[:, :1]),
                            jnp.int32(POS))
    return {"forward": logits, "prefill": pl, "decode": dl}


@pytest.mark.parametrize("kernels_on", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("step", ["forward", "prefill", "decode"])
def test_sharded_model_matches_unsharded(ranks, reference_steps, step,
                                         kernels_on):
    outs, *_ = ranks
    ref = np.asarray(reference_steps[step], np.float32)
    for out in outs:
        res = out["model"][kernels_on]
        got, plain = res["sharded"][step], res["plain"][step]
        _close(got, plain, atol=1e-5)
        _close(got, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=1e-5)
        _close(res["sharded"]["k0"], res["plain"]["k0"], atol=1e-5)


def test_sharded_model_ran_the_sharded_kernels(ranks):
    outs, *_ = ranks
    for out in outs:
        assert out["model"][False]["sharded"]["bodies"]["flash_attention"] \
            == 0
        bodies = out["model"][True]["sharded"]["bodies"]
        n_layers = JCFG.n_layers
        # forward and prefill: one flash body a layer; decode: one decode
        assert bodies["flash_attention"] == 2 * n_layers
        assert bodies["decode_attention"] == n_layers
        assert out["model"][True]["plain"]["bodies"]["flash_attention"] == 0


def test_sharded_train_step_matches_unsharded_and_reference(ranks):
    outs, jparams, tok, lab = ranks
    jstep = jax.jit(jax_make_train_step(JCFG, JaxOptConfig(**OPT)))
    jp, jo, jm = jstep(jparams, jax_init_opt_state(jparams),
                       {"tokens": jnp.asarray(tok),
                        "labels": jnp.asarray(lab)})
    p0 = dict(flatten_with_path(to_port(jparams)))
    want = dict(flatten_with_path(to_port(jp)))
    want_opt = {k: dict(flatten_with_path(to_port(jo[k]))) for k in "mv"}
    for out in outs:
        sharded, plain = out["train"]["sharded"], out["train"]["plain"]
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(sharded["metrics"][k]),
                                       float(plain["metrics"][k]),
                                       rtol=1e-5, atol=1e-12, err_msg=k)
            np.testing.assert_allclose(float(sharded["metrics"][k]),
                                       float(jm[k]), rtol=1e-4, atol=1e-12,
                                       err_msg=k)
        got = dict(flatten_with_path(sharded["params"]))
        base = dict(flatten_with_path(plain["params"]))
        assert got.keys() == base.keys() == want.keys() == p0.keys()
        for key in got:
            # the update, not the parameter: AdamW's first step moves an
            # element by about lr, so a missing or partial update shows
            du = got[key].float() - p0[key].float()
            assert du.abs().max() > 0, f"{key}: the sharded step left it"
            _close(du, base[key].float() - p0[key].float(), atol=3e-4)
            _close(du, want[key].float() - p0[key].float(), atol=3e-4)
        for k in "mv":
            got = dict(flatten_with_path(sharded["opt"][k]))
            base = dict(flatten_with_path(plain["opt"][k]))
            assert got.keys() == want_opt[k].keys()
            for key in got:
                scale = float(want_opt[k][key].abs().max())
                assert scale > 0, f"{k} {key}: no gradient reached it"
                _close(got[key], base[key], atol=1e-5 * scale, rtol=1e-4)
                _close(got[key], want_opt[k][key], atol=1e-5 * scale,
                       rtol=1e-4)


def test_prefetch_places_each_rank_s_block_as_the_reference(ranks):
    """Every rank's local block of each prefetched leaf is the block the
    reference's ``NamedSharding`` gives that device on a (2, 2) mesh of
    the same axis names (device i is rank i, both row-major), for a
    per-leaf rule and for one layout of every leaf; a leaf the rule
    leaves out stays a plain tensor.  The reference's own
    ``prefetch_to_device(sharding=...)``, on its one device, yields the
    same batches in order."""
    from jax._src.op_shardings import op_sharding_to_indices
    from jax.sharding import (AbstractMesh, Mesh, NamedSharding,
                              PartitionSpec as JP)
    from repro.data.pipeline import prefetch_to_device as jax_prefetch
    outs, *_ = ranks
    mesh = AbstractMesh((2, 2), ("data", "model"))

    def blocks(spec, shape):
        hlo = NamedSharding(mesh, JP(*spec))._to_xla_hlo_sharding(len(shape))
        return op_sharding_to_indices(hlo, shape, 4)
    batches = PREFETCH["batches"]
    for tag in ("rule", "pair"):
        for rank, out in enumerate(outs):
            got = out["prefetch"][tag]
            assert len(got) == len(batches)
            for b, want in zip(got, batches):
                assert set(b) == set(want)
                for name, (local, placements) in b.items():
                    spec = PREFETCH["pair"] if tag == "pair" \
                        else PREFETCH["specs"][name]
                    if spec is None:
                        assert placements is None
                        np.testing.assert_array_equal(local.numpy(),
                                                      want[name])
                        continue
                    assert placements is not None
                    block = want[name][blocks(spec, want[name].shape)[rank]]
                    np.testing.assert_array_equal(local.numpy(), block)
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    seen = list(jax_prefetch(iter(batches), size=1, sharding=NamedSharding(
        one, JP("data", None))))
    for b, want in zip(seen, batches, strict=True):
        for name in want:
            np.testing.assert_array_equal(np.asarray(b[name]), want[name])
