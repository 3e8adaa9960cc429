"""The port's content-hashed cache, as ``tests/test_perf_cache.py`` holds
the reference's: a sweep of engines x overlays x devices parses each
module once, a hit is a hit from any consumer, artifacts memoise on
their content, and an artifact path predicts what the reference's
does."""

import json

import pytest

from _torch_perf import assert_same_report, gemm_text, mlp_text
from repro import perf as ref_perf
from repro_torch.arch import Overlay
from repro_torch.perf import (cache_stats, clear_cache, parse_cached,
                              predict, sweep)
from repro_torch.perf.cache import load_artifact


@pytest.fixture(autouse=True)
def fresh_cache():
    clear_cache()
    yield
    clear_cache()


def test_three_engine_two_overlay_sweep_parses_once():
    txt = gemm_text()
    reports = sweep({"gemm": txt}, devices=("mi200", "mi300"),
                    engines=("roofline", "mfma", "scoreboard"),
                    overlays=(Overlay(), Overlay(mfma_scale=2.0)))
    assert len(reports) == 2 * 3 * 2
    assert cache_stats().parses == 1
    predict(txt, device="mi300x", engine="roofline")
    st = cache_stats()
    assert st.parses == 1 and st.hits == 1


def test_distinct_modules_parse_once_each():
    t1, t2 = gemm_text(), mlp_text()
    sweep({"a": t1, "b": t2}, engines=("roofline", "mfma"),
          overlays=(Overlay(), Overlay(clock_scale=1.2)))
    predict(t1, device="mi300", engine="mfma")
    st = cache_stats()
    assert st.parses == 2 and st.hits >= 1


def test_identical_text_shares_entry_and_flag_is_part_of_key():
    t = gemm_text()
    parse_cached(t)
    parse_cached("".join(t))      # another str object, the same content
    st = cache_stats()
    assert st.parses == 1 and st.hits == 1
    parse_cached(t, tpu_correct=False)
    assert cache_stats().parses == 2


def test_artifact_cache_content_hashed(tmp_path):
    rec = {"arch": "qwen2-7b", "shape": "train_4k", "n_devices": 4,
           "hlo": {"flops_per_device": 1e9, "bytes_per_device": 1e6,
                   "collective_wire_bytes": 0.0}}
    p = tmp_path / "cell.json"
    p.write_text(json.dumps(rec))
    assert load_artifact(p) is load_artifact(p)
    st = cache_stats()
    assert st.artifact_loads == 1 and st.artifact_hits == 1
    rec["hlo"]["flops_per_device"] = 2e9
    p.write_text(json.dumps(rec))
    assert load_artifact(p)["hlo"]["flops_per_device"] == 2e9
    assert cache_stats().artifact_loads == 2


@pytest.mark.parametrize("device", ["tpu_v5e", "mi300x", "h100"])
def test_artifact_path_predicts_as_the_reference(tmp_path, device):
    """A dry-run record's totals through the roofline; the H100, which
    the reference does not register, against its own spec."""
    rec = {"arch": "qwen2-7b", "shape": "train_4k", "n_devices": 4,
           "hlo": {"flops_per_device": 1e12, "bytes_per_device": 1e9,
                   "collective_wire_bytes": 1e8, "flash_block_bytes": 2e8}}
    p = tmp_path / "qwen2-7b_train_4k_single.json"
    p.write_text(json.dumps(rec))
    rep = predict(str(p), device=device, engine="roofline")
    assert rep.workload == "qwen2-7b/train_4k" and rep.total_time_s > 0
    assert predict(p, device=device, engine="roofline") == rep
    if device == "h100":
        from repro_torch.arch import get_device
        spec = get_device("h100")
        assert rep.memory_time_s == (1e9 - 2e8) / spec.memory.hbm_bw
        assert rep.compute_time_s == 1e12 / spec.peak_flops
    else:
        assert_same_report(rep, ref_perf.predict(str(p), device=device,
                                                 engine="roofline"))
