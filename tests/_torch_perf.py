"""Helpers shared by the perf pipeline's tests
(``tests/test_torch_perf_ir.py``, ``test_torch_perf_engines.py``,
``test_torch_perf_cache.py``, ``test_torch_hlo_bridge.py``,
``test_torch_graph.py``, ``test_torch_whatif.py``): the reference
tests' HLO texts, each compiled at most once a process, the reduced
qwen2-7b lowered as ``examples/whatif_analysis.py`` lowers it, and the
comparisons that hold the port's graphs and reports to the reference's
field for field."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import pytest

from repro.arch import overlay as ref_overlay
from repro_torch.arch import overlay as port_overlay
from test_hlo_analysis import _HLO_COLLECTIVES
from test_perf_ir import _while_module

REF_DEVICES = ("mi200", "mi300", "mi300x", "tpu_v5e", "tpu_v5p")
ENGINES = ("roofline", "mfma", "scoreboard")
#: tests/test_perf_engines.py's overlay scenarios (no table patches:
#: those would bolt a cycle table onto MXU devices)
OVERLAYS = ({}, {"mfma_scale": 2.0}, {"mfma_scale": 0.5, "clock_scale": 1.2})
#: a composed grid, the what-if example's
GRID = dict(mfma_scale=(0.5, 1, 2), clock_scale=(1, 1.2))
#: the reduced qwen2-7b's batch (examples/whatif_analysis.py) and the
#: decode step's
LOSS_BATCH = (2, 64)
DECODE = dict(B=2, max_len=128, pos=37)
#: the one float tolerance: rounding, nothing else
REL = 1e-12


def overlay_pair(kw):
    """The same scenario as (port, reference) ``Overlay``s."""
    return port_overlay.Overlay(**kw), ref_overlay.Overlay(**kw)


@functools.lru_cache(maxsize=None)
def gemm_text() -> str:
    """``tests/test_perf_engines.py``'s ``gemm_txt``: 256^2 bf16 @ 256^2."""
    a = jax.ShapeDtypeStruct((256, 256), jnp.bfloat16)
    return jax.jit(lambda x, y: x @ y).lower(a, a).compile().as_text()


@functools.lru_cache(maxsize=None)
def mlp_text() -> str:
    """``tests/test_perf_engines.py``'s ``mlp_txt``: two dots + gelu."""
    a = jax.ShapeDtypeStruct((64, 128), jnp.bfloat16)
    w1 = jax.ShapeDtypeStruct((128, 256), jnp.bfloat16)
    w2 = jax.ShapeDtypeStruct((256, 32), jnp.bfloat16)
    return jax.jit(lambda x, u, v: jax.nn.gelu(x @ u) @ v).lower(
        a, w1, w2).compile().as_text()


_OPAQUE_COND = """
  %ci = s32[] get-tuple-element(%cp), index=0
  %cz = s32[] constant(0)
  ROOT %cne = pred[] compare(%ci, %cz), direction=NE
"""


def hand_texts():
    """The reference tests' hand-written modules: the nested whiles of
    ``tests/test_perf_ir.py`` in each trip-count variant and the
    collectives of ``tests/test_hlo_analysis.py``."""
    known = ', backend_config={"known_trip_count":{"n":"%d"}}'
    return {
        "whiles_known": _while_module(known % 5, known % 3),
        "whiles_condition": _while_module("", ""),
        "whiles_unknown_inner": _while_module("", "",
                                              cond_body=_OPAQUE_COND),
        "whiles_known_outer": _while_module(known % 2, ""),
        "collectives": _HLO_COLLECTIVES,
    }


def reduced_qwen_text(kind: str) -> str:
    """The reference's reduced qwen2-7b lowered and compiled with faithful
    bf16 dots (the caller sets ``REPRO_CPU_F32_DOTS=0``): ``"loss"`` is
    ``loss_fn`` on ``LOSS_BATCH`` tokens, as ``examples/whatif_analysis.py``
    lowers it; ``"decode"`` one ``decode_step`` of ``DECODE``."""
    from repro.configs import get_config
    from repro.models import init_params
    from repro.models.model import decode_step, init_cache, loss_fn
    cfg = get_config("qwen2-7b").reduced()
    params = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    if kind == "loss":
        tok = jax.ShapeDtypeStruct(LOSS_BATCH, jnp.int32)
        return jax.jit(lambda p, b: loss_fn(cfg, p, b)).lower(
            params, {"tokens": tok, "labels": tok}).compile().as_text()
    cache = jax.eval_shape(lambda: init_cache(cfg, DECODE["B"],
                                              DECODE["max_len"]))
    tok = jax.ShapeDtypeStruct((DECODE["B"], 1), jnp.int32)
    pos = jax.ShapeDtypeStruct((), jnp.int32)
    return jax.jit(lambda p, c, t, q: decode_step(cfg, p, c, t, q)).lower(
        params, cache, tok, pos).compile().as_text()


def plain(obj):
    """A dataclass tree as plain data (class names dropped), so one
    package's object compares with the other's."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def assert_close(got, want, path="", rel=REL):
    """Equal plain data, floats within ``rel`` (rounding only)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got) if isinstance(got, dict) else got,
             sorted(want))
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}", rel)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]", rel)
    elif isinstance(want, float) and not isinstance(want, bool):
        if math.isinf(want) or want == 0.0:
            assert got == want, (path, got, want)
        else:
            assert got == pytest.approx(want, rel=rel, abs=0.0), \
                (path, got, want)
    else:
        assert got == want, (path, got, want)


def assert_same_report(port_rep, ref_rep):
    assert_close(plain(port_rep), plain(ref_rep))
