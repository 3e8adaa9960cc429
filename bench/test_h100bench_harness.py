"""CPU tests of the benchmark's arithmetic, traffic and data layout.

They need no card: the window's slicing and percentiles on synthetic
streams, the operation and byte counts against hand-worked cases, the
trace reader on synthetic events, each mix's tick arrival rate on the
scheduler's tick replay, and a configuration, traffic mix, cell and
metric added as new files in a copy of the benchmark, found by name
with no file that was there edited.
"""

import hashlib
import json
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from h100bench import peaks, replay, trace, traffic, weights, window  # noqa: E402
from h100bench.registry import Registry  # noqa: E402

REG = Registry()


class _R:
    """A request's record as the engine gives it (the fields read)."""

    def __init__(self, admit, emits, admitted=0, status="OK", prompt_len=10,
                 prefix_blocks=0):
        self.admit_time, self.emit_times = admit, list(emits)
        self.admitted, self.status = admitted, status
        self.prompt_len, self.prefix_blocks = prompt_len, prefix_blocks


def test_window_slices_tokens_first_tokens_and_gaps():
    rs = [_R(0.5, [1.0, 1.5, 2.5, 4.2]),        # admitted before the window
          _R(1.2, [1.9, 2.0, 3.1]),             # admitted in it
          _R(3.9, [4.5]),                       # first token after it
          _R(4.1, [4.4])]                       # admitted after it
    start, end = 1.0, 4.0
    assert window.tokens_in(rs, start, end) == 3 + 3
    assert [r.admit_time for r in window.admitted_in(rs, start, end)] == \
        [1.2, 3.9]
    assert window.ttfts(rs, start, end) == pytest.approx([0.7, 0.6])
    assert sorted(window.gaps(rs, start, end)) == \
        pytest.approx(sorted([0.5, 1.0, 0.1, 1.1]))


@pytest.mark.parametrize("p", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(p):
    v = np.random.default_rng(3).lognormal(size=37).tolist()
    assert window.percentile(v, p) == pytest.approx(np.percentile(v, p))
    assert math.isnan(window.percentile([], p))


def _dims():
    return weights.dims({"hidden_size": 8, "num_attention_heads": 2,
                         "num_key_value_heads": 1, "head_dim": 4,
                         "num_hidden_layers": 3, "vocab_size": 10,
                         "intermediate_size": 6})


def test_model_counts_by_hand():
    m = REG.counts("model")
    d = _dims()
    # attention 2*8*2*4 + 2*8*1*4 = 192 weights, FFN 3*8*6 = 144
    assert m.attn_params(d) == 192 and m.ffn_params_per_token(d) == 144
    # one row through 3 layers attending 5 keys: 3 * (2 * 336 + 4*2*4*5)
    assert m.row_flops(d, 5) == 3 * (672 + 160)
    # rows at positions 4, 5, 6 attend 5 + 6 + 7 keys
    assert m.prefill_flops(d, 4, 3) == 3 * 3 * 672 + 4 * 3 * 8 * 18
    # ACTIVE rows at lengths 0 and 2: keys 1 and 3, each unembedded
    assert m.decode_flops(d, [0, 2]) == \
        m.row_flops(d, 1) + m.row_flops(d, 3) + 2 * 2 * 8 * 10
    # weights: 3 layers of (192 + 2 norms of 8 + 144) bf16, unembed, norm
    assert m.weight_bytes(d) == 2 * (3 * (192 + 16 + 144) + 80 + 8)
    kv = 2 * 3 * 1 * 4 * 2
    assert m.decode_bytes(d, [0, 2]) == \
        m.weight_bytes(d) + kv * 4 + 2 * (8 * 2 + 10 * 4)


def test_moe_counts_read_only_experts_that_took_rows():
    d = weights.dims({"hidden_size": 8, "num_attention_heads": 2,
                      "num_key_value_heads": 1, "head_dim": 4,
                      "num_hidden_layers": 2, "vocab_size": 10,
                      "num_experts": 4, "num_experts_per_tok": 2,
                      "moe_intermediate_size": 6})
    m = REG.counts("model")
    assert m.ffn_params_per_token(d) == 2 * 3 * 8 * 6 + 8 * 4
    base = m.weight_bytes(d, [0, 0])
    assert m.weight_bytes(d, [1, 3]) - base == 4 * 3 * 8 * 6 * 2
    assert m.weight_bytes(d) - base == 8 * 3 * 8 * 6 * 2
    g = REG.counts("moe_gmm")
    rows = [3, 0, 5, 0]
    assert g.flops(8, 6, rows) == 2 * 8 * 6 * 8
    assert g.nbytes(8, 6, rows) == 2 * (2 * 8 * 6 + 8 * (8 + 6))


def test_paged_attention_counts():
    a = REG.counts("paged_decode_attention")
    assert a.flops(2, 4, [1, 3]) == 4 * 2 * 4 * 4
    assert a.nbytes(2, 1, 4, [1, 3], table_entries=6) == \
        2 * (2 * 1 * 4 * 4 + 2 * 2 * 2 * 4) + 4 * 6
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("kernel,name,hit", [
    ("moe_gmm", "void gmm_ring_kernel<64>(unsigned short const*, int)", True),
    ("moe_gmm", "void gmm_kernel<__nv_bfloat16>(float*)", True),
    ("moe_gmm", "void mma_gemm_kernel(unsigned short const*)", False),
    ("paged_decode_attention",
     "void decode_split::mma_split_kernel<decode_split::PagedRows, "
     "__nv_bfloat16, 128>(decode_split::Params)", True),
    ("paged_decode_attention", "void mma_flash_kernel(float*)", False)])
def test_kernel_names(kernel, name, hit):
    import re
    assert bool(re.search(REG.counts(kernel).KERNELS, name)) == hit


def test_trace_busy_idle_and_labels():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.decode",
           "ts": 100.0, "dur": 50.0},
          {"ph": "X", "cat": "user_annotation", "name": "bench.prefill",
           "ts": 300.0, "dur": 180.0},
          {"ph": "X", "cat": "kernel", "name": "void gmm_ring_kernel<64>(int)",
           "ts": 120.0, "dur": 60.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 150.0,
           "dur": 60.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 320.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 500.0,
           "dur": 20.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
           "dur": 9999.0}]
    s = trace.summarize_events(ev)
    assert s.window_s == pytest.approx(420e-6)          # 100 .. 520
    assert s.busy_s == pytest.approx((90 + 10 + 20) * 1e-6)
    assert s.kernel_s(REG.counts("moe_gmm").KERNELS) == pytest.approx(60e-6)
    labels = dict((round(g * 1e6), lab) for lab, g in s.gaps)
    assert labels == {20: "host in bench.decode",
                      110: "host outside the engine's steps",
                      170: "host in bench.prefill"}
    b = s.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(80e-6)]
    assert b["device_ops"][1][0] == "gmm_ring_kernel<64>"
    assert b["idle_gaps"][0] == ["host in bench.prefill",
                                 pytest.approx(170e-6)]


def test_traffic_same_schedule_for_every_seed():
    """Every seed gets the same arrivals and sizes; the seed draws the
    tokens."""
    for mix_name in ("chat", "longdoc"):
        mix = REG.traffic(mix_name)
        a = traffic.generate(mix, 1, 1000, 300)
        b = traffic.generate(mix, 2**33 + 5, 1000, 300)
        assert [(r.arrival, r.session, r.question, len(r.prompt), r.n_steps)
                for r in a] == \
            [(r.arrival, r.session, r.question, len(r.prompt), r.n_steps)
             for r in b]
        assert not any(np.array_equal(x.prompt, y.prompt)
                       for x, y in zip(a, b))
        assert traffic.generate(mix, 1, 1000, 300)[5].prompt.tolist() == \
            a[5].prompt.tolist()
        short = traffic.generate(mix, 1, 1000, 200)
        assert [r.arrival for r in short] == \
            [r.arrival for r in a if r.arrival < 200]


def test_stratified_blocks_span_the_distribution():
    mix = REG.traffic("chat")
    pool = traffic.quantiles(mix["output"])
    assert pool.min() >= 16 and pool.max() <= 896
    cuts = np.sort(pool)[::len(pool) // traffic.BLOCK]
    for field in (2, 3):
        f = traffic._Field(pool, field)
        draws = [f.next() for _ in range(4 * traffic.BLOCK)]
        for k in range(0, len(draws), traffic.BLOCK):
            bands = np.searchsorted(cuts, draws[k:k + traffic.BLOCK],
                                    side="right")
            assert sorted(bands) == list(range(1, traffic.BLOCK + 1))
    p, o = traffic._Field(pool, 2), traffic._Field(pool, 3)
    pairs = [(p.next(), o.next()) for _ in range(traffic.POOL)]
    assert abs(np.corrcoef(np.array(pairs).T)[0, 1]) < 0.2
    res = traffic.residuals(pool)
    assert res.min() >= 1 and np.mean(res) > np.mean(pool) / 2


@pytest.mark.parametrize("cell", ["qwen3-moe-8l.chat", "qwen2-7b.longdoc"])
def test_tick_rate_keeps_about_ninety_percent_active(cell):
    wl = REG.workload(cell)
    mix = REG.traffic(wl["traffic"])
    rec = replay.replay(wl, mix, 987654321012, mix["replay_ticks"])
    assert rec.start == wl["start_step"]
    assert 0.85 <= rec.occupancy(mix["replay_ticks"]) <= 0.95


def test_benchmark_names_every_piece_by_its_files():
    spec = REG.benchmark()
    for c in spec["configs"]:
        assert REG.config(c["name"])["reduced"] == c["reduced"]
        assert (ROOT / c["file"]).is_file()
        REG.reference(REG.config(c["name"])["reference"])
    for w in spec["workloads"]:
        wl = REG.workload(w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(REG.metric(m["name"]).read)
    names = [m["name"] for m in REG.metrics_of("qwen2-7b.longdoc", True)]
    assert "moe_gmm.roofline" not in names and "mfu" in names
    assert "engine.prefix_hit_rate" not in \
        [m["name"] for m in REG.metrics_of("qwen3-moe-8l.chat", True)]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_new_cell_config_mix_and_metric_are_files_alone(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as new
    files and entries in a copy: the harness finds and runs them, and
    no file that was there changes."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    b = root / "bench"
    before = _digest(b)
    cfg = dict(REG.config("qwen2-7b"))
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=32, num_hidden_layers=2, vocab_size=256,
               intermediate_size=96, reduced=["num_hidden_layers"])
    (b / "configs" / "tiny-dense.json").write_text(json.dumps(cfg))
    mix = {"kind": "independent", "rate_per_tick": 1.0, "initial": 3,
           "prompt": {"dist": "loguniform", "min": 4, "max": 40},
           "output": {"dist": "uniform", "min": 3, "max": 12}}
    (b / "traffic" / "burst-short.json").write_text(json.dumps(mix))
    wl = {"config": "tiny-dense", "traffic": "burst-short",
          "engine": {"max_batch": 4, "max_len": 64, "page": 16,
                     "prefill_chunk": 16, "n_blocks": None},
          "start_step": 3, "trace_seconds": 0.3,
          "check": {"requests": 2, "min_tokens": 1,
                    "limits": {"max_logit_gap": 1.0}}}
    (b / "workloads" / "tiny-dense.burst-short.json").write_text(
        json.dumps(wl))
    (b / "metrics" / "engine.prefill_calls.py").write_text(
        "def read(run):\n"
        "    return sum(1 for s in run.prefills if s.in_window)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-dense", "source": "test",
                            "file": "bench/configs/tiny-dense.json",
                            "reduced": ["num_hidden_layers"], "why": "test"})
    spec["workloads"].append({"name": "tiny-dense.burst-short",
                              "config": "tiny-dense",
                              "traffic": "burst-short", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "engine.prefill_calls", "unit": "1",
                              "better": "lower",
                              "source": "program_counter", "layer": "engine",
                              "moves": "ttft_p90_ms",
                              "workloads": ["tiny-dense.burst-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    from h100bench import harness
    reg = Registry(root)
    for traced in (False, True):
        out = harness.run_cell("tiny-dense.burst-short", 5, 1.5, traced,
                               t_start=0.0, device="cpu", registry=reg)
        assert out["correct"] and out["failed"] == 0
        if traced:
            assert out["metrics"]["engine.prefill_calls"]["value"] > 0
        else:
            assert {"output_tokens_per_s", "ttft_p90_ms", "itl_p95_ms",
                    "setup_s"} <= set(out["metrics"])
    after = _digest(b)
    assert {k: v for k, v in after.items() if k in before} == before
