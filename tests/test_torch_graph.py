"""The port's graph source (``perf/torch_graph.py``) against the
reference's lowering: reduced qwen2-7b's ``loss_fn`` on (2, 64) tokens,
as ``examples/whatif_analysis.py`` lowers it, and its ``decode_step`` at
B = 2, both compiled by XLA with faithful bf16 dots
(``REPRO_CPU_F32_DOTS=0``) and parsed, against the port's plain path
captured on the meta device.

The dot FLOPs are equal exactly, and so are the dot sites (counted over
merged calls, an m x n product equal to its n x m transpose: XLA
computes p.v as (v^T p^T)).  One difference is named, not absorbed: in
the decode step XLA:CPU feeds its two attention products (q.k^T and p.v,
``DECODE_F32_SITES``) f32 copies of the bf16 operands, so the reference's
parse types them f32; the port records them bf16, as a matrix unit runs
them (the capture's rule for exact upcasts, which ``parse_module``'s
``tpu_correct`` makes for XLA:CPU's converts).  With those two sites
retyped the ``mfma`` engine's time is equal to rounding on every
device.  Bytes are not compared across frameworks; the port's cover the
parameters it reads."""

import collections
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import pytest
import torch

from _torch_perf import (DECODE, LOSS_BATCH, REF_DEVICES, REL,
                         reduced_qwen_text)
from repro import perf as ref_perf
from repro.perf import hlo_ir as ref_ir
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_params, loss_fn
from repro_torch.models import attention as attn_mod
from repro_torch.perf import RooflineEngine, predict
from repro_torch.perf.torch_graph import (ON_CHIP, capture, meta_cache,
                                          meta_params, meta_tokens)

ROOT = Path(__file__).resolve().parent.parent
CFG = dataclasses.replace(get_config("qwen2-7b").reduced(),
                          use_kernels=False)
G = CFG.n_heads
#: (batch, m, n, k) of the decode step's attention products in the
#: reference's parse, which XLA:CPU compiles on f32 copies
DECODE_F32_SITES = {(DECODE["B"] * G, 1, DECODE["max_len"], CFG.hd),
                    (DECODE["B"] * G, CFG.hd, 1, DECODE["max_len"])}


@pytest.fixture(scope="module")
def reference():
    """The reference's parsed graphs (two compiles)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CPU_F32_DOTS", "0")
        return {kind: ref_ir.parse_module(reduced_qwen_text(kind))
                for kind in ("loss", "decode")}


@pytest.fixture(scope="module")
def params():
    return meta_params(CFG)


@pytest.fixture(scope="module")
def port(params):
    tok = meta_tokens(LOSS_BATCH)
    return {"loss": capture(loss_fn, CFG, params,
                            {"tokens": tok, "labels": tok}),
            "decode": capture(decode_step, CFG, params,
                              meta_cache(CFG, DECODE["B"], DECODE["max_len"]),
                              meta_tokens((DECODE["B"], 1)), DECODE["pos"])}


def _sites(graph):
    """Dot sites as {(batch, min(m, n), max(m, n), k, dtype): calls}."""
    out = collections.Counter()
    for op, cnt in graph.dot_pairs():
        out[(op.batch, min(op.m, op.n), max(op.m, op.n), op.k,
             op.dtype)] += cnt
    return dict(out)


def _retyped(graph, sites, dtype):
    ops = [dataclasses.replace(op, dtype=dtype)
           if op.kind == "dot" and (op.batch, op.m, op.n, op.k) in sites
           else op for op in graph.ops]
    return dataclasses.replace(graph, ops=ops)


@pytest.mark.parametrize("kind", ["loss", "decode"])
def test_dot_flops_equal_the_reference_lowering(kind, reference, port):
    assert port[kind].flops == reference[kind].flops
    assert port[kind].flops == sum(op.count * op.flops
                                   for op in port[kind].dots)
    assert port[kind].source == "torch" and not port[kind].collectives


def test_loss_sites_and_mfma_time_equal_reference(reference, port):
    """No site differs: the same products, the same dtypes, so the
    ``mfma`` engine agrees to rounding on every device."""
    assert _sites(port["loss"]) == _sites(reference["loss"])
    for device in REF_DEVICES:
        got = predict(port["loss"], device=device, engine="mfma")
        want = ref_perf.predict(reference["loss"], device=device,
                                engine="mfma")
        assert got.total_time_s == pytest.approx(want.total_time_s,
                                                 rel=REL, abs=0.0)
        assert got.metrics["total_mfma"] == want.metrics["total_mfma"]


def test_decode_sites_differ_only_at_the_named_f32_sites(reference, port):
    """XLA:CPU's f32 attention products, named in ``DECODE_F32_SITES``:
    exactly those two reference sites are f32, and with them retyped
    bf16 the sites and the ``mfma`` times are equal."""
    ref = reference["decode"]
    f32 = {(op.batch, op.m, op.n, op.k) for op in ref.dots
           if op.dtype == "f32"}
    assert f32 == DECODE_F32_SITES
    assert all(op.dtype == "bf16" for op in port["decode"].dots)
    fixed = _retyped(ref, DECODE_F32_SITES, "bf16")
    assert _sites(port["decode"]) == _sites(fixed)
    for device in REF_DEVICES:
        got = predict(port["decode"], device=device, engine="mfma")
        want = ref_perf.predict(fixed, device=device, engine="mfma")
        assert got.total_time_s == pytest.approx(want.total_time_s,
                                                 rel=REL, abs=0.0)
    raw = ref_perf.predict(ref, device="mi300", engine="mfma")
    assert predict(port["decode"], device="mi300",
                   engine="mfma").total_time_s < raw.total_time_s


def _param_bytes(params):
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(params))


@pytest.mark.parametrize("kind, rows", [("loss", LOSS_BATCH[0]
                                         * LOSS_BATCH[1]),
                                        ("decode", DECODE["B"])])
def test_bytes_cover_the_parameters(kind, rows, params, port):
    """Every weight is read at least once, on the kernel path too (the
    bytes less the attention intermediates), but the embedding table,
    whose gather reads only its rows."""
    g = port[kind]
    embed = params["embed"]
    need = (_param_bytes(params) - embed.numel() * embed.element_size()
            + rows * CFG.d_model * embed.element_size())
    assert g.bytes_accessed - g.flash_block_bytes >= need
    assert g.bytes_accessed == sum(g.bytes_by_opcode.values())
    assert g.bytes_accessed == pytest.approx(sum(
        op.count * op.bytes for op in g.ops))


def test_attention_intermediates_are_the_kernel_adjustment(port):
    """``flash_block_bytes`` is what the kernels keep on chip: positive,
    part of the bytes, and the kernel-adjusted roofline's saving."""
    for g in port.values():
        assert 0 < g.flash_block_bytes < g.bytes_accessed
        adj = predict(g, device="h100", engine="roofline")
        raw = predict(g, device="h100",
                      engine=RooflineEngine(kernel_adjusted=False))
        assert raw.memory_time_s - adj.memory_time_s == pytest.approx(
            g.flash_block_bytes / 3.35e12)
    for mod_name, names in ON_CHIP.items():
        assert mod_name == attn_mod.__name__
        for name in names:
            assert not hasattr(getattr(attn_mod, name), "__wrapped__")
            assert getattr(attn_mod, name).__module__ == mod_name


def test_sites_merge_over_layers_and_keys_hash_the_ops(params, port):
    """A Python loop over layers gives one site per product with its
    calls as the count, as a scanned HLO loop does; the key hashes the
    recorded ops."""
    L = CFG.n_layers
    counts = sorted(op.count for op in port["decode"].dots)
    assert counts[0] == 1 and all(c % L == 0 for c in counts[1:])
    again = capture(decode_step, CFG, params,
                    meta_cache(CFG, DECODE["B"], DECODE["max_len"]),
                    meta_tokens((DECODE["B"], 1)), DECODE["pos"])
    assert again.key == port["decode"].key
    assert again.key != port["loss"].key


def test_cpu_capture_records_the_same_products():
    """On CPU tensors the function really runs and ``layers.mm`` upcasts
    its bf16 products; the capture records them as the bf16 products
    they are, so the sites equal the meta capture's, and the upcasts'
    copies add bytes."""
    params = init_params(CFG, torch.Generator().manual_seed(0),
                         device="cpu")
    tok = torch.zeros(LOSS_BATCH, dtype=torch.int32)
    cpu = capture(loss_fn, CFG, params, {"tokens": tok, "labels": tok})
    meta = capture(loss_fn, CFG, meta_params(CFG),
                   {"tokens": meta_tokens(LOSS_BATCH),
                    "labels": meta_tokens(LOSS_BATCH)})
    assert _sites(cpu) == _sites(meta)
    assert cpu.bytes_accessed > meta.bytes_accessed


def test_example_runs_at_the_reduced_size():
    spec = importlib.util.spec_from_file_location(
        "torch_whatif_analysis",
        ROOT / "examples" / "torch_whatif_analysis.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert example.main(["--scales", "1,2",
                             "--devices", "mi300,tpu_v5e,h100"]) == 0
    text = out.getvalue()
    assert "qwen2-7b-smoke (reduced) train step: 0.18 GFLOP" in text
    assert "h100       roofline only" in text
    assert "| qwen2-7b             | mi300x     | scoreboard |" in text
    with pytest.raises(SystemExit):
        example.main(["--grid-device", "h100"])
