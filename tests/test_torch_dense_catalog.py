"""The three dense configs of the catalog the earlier slices did not
serve (internlm2-20b, mistral-nemo-12b, yi-34b) against the reference,
reduced, on the CPU.

They need no new layer kind: plain GQA attention and a SwiGLU MLP, at
other head groupings (the reduced configs all group 4 query heads over
2 KV heads; the full ones group 6, 4 and 7 with head dim 128, and
mistral-nemo's head dim is not d_model / n_heads).  ``forward``,
``prefill`` and ``decode_step`` are held to the reference in float32
(rtol 1e-5) and bfloat16 (rtol 2e-2) on both paths, the reference's
Pallas kernels asserted to have run on its kernel path.  Both engines'
float32 greedy streams must equal the reference's: the sync engine on
the ``base`` trace, the paged one on the ``shared_prefix`` trace (with
``page=128`` on both sides), the port on its kernel path (the kernels'
plain versions on the CPU), the reference on its plain path.
"""

import dataclasses

import numpy as np
import pytest

from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.traces import get_trace as jax_get_trace
from repro_torch.serve import OK, PagedServeEngine, ServeEngine, get_trace

from _torch_catalog import (CASE_IDS, CASES, check_forward,
                            check_prefill_decode, models)

DENSE = ["internlm2-20b", "mistral-nemo-12b", "yi-34b"]
ATTN = {"flash_attention": True}


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_reference(arch, dtype, kernels):
    check_forward(arch, dtype, kernels, ATTN)


@pytest.mark.parametrize("dtype,kernels", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_step_match_reference(arch, dtype, kernels):
    check_prefill_decode(arch, dtype, kernels, ATTN)


def _same_streams(jres, res):
    for i, (a, b) in enumerate(zip(jres, res)):
        assert len(a.tokens) == len(b.tokens), i
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(i))


@pytest.mark.parametrize("arch", DENSE)
def test_sync_engine_streams_match_reference(arch):
    jcfg, jparams, cfg, params = models(arch)
    cfg = dataclasses.replace(cfg, use_kernels=True)
    kw = dict(max_len=128, seed=3)
    jreqs = jax_get_trace("base")(3, cfg.vocab_size, **kw)
    reqs = get_trace("base")(3, cfg.vocab_size, **kw)
    for a, b in zip(jreqs, reqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        a.n_steps = b.n_steps = 16
    jres, jstats = JaxServeEngine(jcfg, jparams, max_len=128).run(jreqs)
    res, stats = ServeEngine(cfg, params, max_len=128, device="cpu").run(reqs)
    assert stats.decode_steps == jstats.decode_steps == 48
    _same_streams(jres, res)


@pytest.mark.parametrize("arch", DENSE)
def test_paged_engine_streams_match_reference(arch):
    jcfg, jparams, cfg, params = models(arch)
    cfg = dataclasses.replace(cfg, use_kernels=True)
    kw = dict(max_len=256, max_batch=4, page=128)
    jreqs = jax_get_trace("shared_prefix")(4, cfg.vocab_size, seed=1,
                                           prefix_len=128)
    reqs = get_trace("shared_prefix")(4, cfg.vocab_size, seed=1,
                                      prefix_len=128)
    jres, jstats = JaxPagedServeEngine(jcfg, jparams, **kw).run(jreqs)
    res, stats = PagedServeEngine(cfg, params, device="cpu", **kw).run(reqs)
    for f in ("ticks", "decode_steps", "prefill_chunks",
              "prefix_blocks_reused"):
        assert stats[f] == jstats[f], f
    assert stats.prefix_hit_rate > 0
    assert [r.status for r in res] == [OK] * len(reqs)
    _same_streams(jres, res)


def test_full_configs_group_heads_as_published():
    """The groupings the card runs: G = 6 (internlm2), 4 with head dim
    128 where d_model / n_heads is 160 (mistral-nemo), 7 (yi)."""
    from repro_torch.configs import get_config
    got = {a: (get_config(a).n_heads // get_config(a).n_kv_heads,
               get_config(a).hd, get_config(a).d_model // get_config(a).n_heads)
           for a in DENSE}
    assert got == {"internlm2-20b": (6, 128, 128),
                   "mistral-nemo-12b": (4, 128, 160),
                   "yi-34b": (7, 128, 128)}
