"""The launch layer against the reference: ``roofline_row`` on one record
for every device of the port's registry, the shape cells, and the
dry-run of reduced qwen2-7b's ``decode_32k`` cell on an 8-rank (4, 2)
fake mesh.

The same cell of reduced qwen3-moe runs beside it (its MoE layers'
slot maps, dispatch and combine on the mesh, the experts on the model
axis).  The dry-run runs in a subprocess (its ``fake`` process group
must not outlive it in a pytest worker) and each record is held to two
counts taken without a mesh: its per-device parameter bytes equal the sum of each leaf's
local block by the axis rules, and its dot FLOPs times the 8 ranks
equal ``perf.torch_graph.capture``'s of the unsharded step (no product
is lost or repeated on another rank).  The reference's ``repro.launch``
modules are imported with the environment restored afterwards.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.arch import get_device, list_devices
from repro_torch.configs import SHAPES, all_cells, applicable
from repro_torch.launch import roofline
from repro_torch.perf.engines import RooflineEngine
from repro_torch.perf.hlo_ir import KernelGraph

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    """``repro.launch.roofline`` and ``repro.configs``, the environment
    restored after their import."""
    env = dict(os.environ)
    try:
        from repro import configs as jax_configs
        from repro.launch import roofline as jax_roofline
    finally:
        os.environ.clear()
        os.environ.update(env)
    return jax_roofline, jax_configs


def _rec(f=1.2e12, b=3.4e9, c=5.6e8, flash=1.1e8, arch="qwen2-7b"):
    return {"arch": arch, "shape": "train_4k", "mesh": "16x16",
            "n_devices": 256, "n_params": int(7e9),
            "hlo": {"flops_per_device": f, "bytes_per_device": b,
                    "collective_wire_bytes": c, "flash_block_bytes": flash,
                    "collectives": {}},
            "memory": {"total_bytes_per_device": 8 * 2**30}}


@pytest.mark.parametrize("device", list(list_devices()))
def test_roofline_row_equals_the_references(reference, device):
    jax_roofline, _ = reference
    from repro.arch import list_devices as jax_list_devices
    spec = get_device(device)
    row = roofline.roofline_row(_rec(), spec)
    if device in set(jax_list_devices()):
        from repro.arch import get_device as jax_get_device
        assert row == jax_roofline.roofline_row(_rec(),
                                                jax_get_device(device))
    g = KernelGraph.from_totals(flops=1.2e12, bytes_accessed=3.4e9,
                                collective_wire=5.6e8,
                                flash_block_bytes=1.1e8)
    rep = RooflineEngine().estimate(g, spec)
    assert (row["compute_t"], row["memory_t"], row["collective_t"],
            row["dominant"]) == (rep.compute_time_s, rep.memory_time_s,
                                 rep.collective_time_s, rep.bound)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "deepseek-v2-lite-16b", "jamba-v0.1-52b"])
def test_moe_active_fraction_equals_the_references(reference, arch):
    jax_roofline, _ = reference
    assert math.isclose(roofline.active_fraction(arch),
                        jax_roofline.active_fraction(arch), rel_tol=1e-12)
    rec = _rec(arch=arch)
    assert roofline.roofline_row(rec, get_device("tpu_v5e")) == \
        jax_roofline.roofline_row(rec)


def test_default_device_is_the_h100():
    row = roofline.roofline_row(_rec())
    assert row == roofline.roofline_row(_rec(), get_device("h100"))


def test_shape_cells_equal_the_references(reference):
    _, jax_configs = reference
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in jax_configs.SHAPES.items()}
    assert all_cells() == jax_configs.all_cells()
    assert applicable("qwen2-7b", "long_500k") == \
        jax_configs.applicable("qwen2-7b", "long_500k")


_DRYRUN = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.model import decode_step, param_axes_rule
    from repro_torch.parallel.api import logical_to_spec
    from repro_torch.perf.torch_graph import (capture, meta_cache,
                                              meta_params, meta_tokens)
    from repro_torch.tree import flatten_with_path

    out = {}
    with dryrun.fake_world(8):
        mesh = make_smoke_mesh((4, 2), device="cpu")
        sizes = {"data": 4, "model": 2}
        for arch in ("qwen2-7b", "qwen3-moe-235b-a22b"):
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      use_kernels=False)
            rec = dryrun.run_cell(arch, "decode_32k", cfg=cfg, mesh=mesh,
                                  verbose=False)
            want = 0
            for path, leaf in flatten_with_path(meta_params(cfg)):
                spec = logical_to_spec(leaf.shape,
                                       param_axes_rule(path, leaf), mesh)
                parts = 1
                for p in spec:
                    for ax in (() if p is None else (p,)
                               if isinstance(p, str) else p):
                        parts *= sizes[ax]
                want += leaf.numel() * leaf.element_size() // parts
            unsharded = capture(decode_step, cfg, meta_params(cfg),
                                meta_cache(cfg, 128, 32768),
                                meta_tokens((128, 1)), 32767)
            out[arch] = {"rec": rec, "param_bytes": want,
                         "unsharded_flops": unsharded.flops}
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def dryrun_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "rec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _DRYRUN, str(out)],
                         capture_output=True, text=True, cwd=str(ROOT),
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


def _parameter_bytes_are_the_local_blocks(cell):
    rec = cell["rec"]
    assert rec["n_devices"] == 8 and rec["mesh"] == "4x2"
    assert rec["memory"]["param_bytes_per_device"] == cell["param_bytes"]
    assert rec["memory"]["alias_size_in_bytes"] > 0      # the cache, in place
    assert "temp_size_in_bytes" in rec["memory"]["not_measured"]


def _dot_flops_over_ranks_equal_the_unsharded(cell):
    rec = cell["rec"]
    assert rec["hlo"]["flops_per_device"] * rec["n_devices"] == \
        cell["unsharded_flops"]


def _record_feeds_the_roofline(rec, tmp_path):
    hlo = rec["hlo"]
    assert hlo["bytes_per_device"] > 0
    assert hlo["collective_wire_bytes"] > 0    # model shards the weights
    assert sum(v["count"] for v in hlo["collectives"].values()) == \
        sum(rec["comm_counts"].values())
    (tmp_path / f"{rec['arch']}_decode_32k_single.json").write_text(
        json.dumps(rec))
    rows = roofline.load_cells(str(tmp_path))
    assert len(rows) == 1 and rows[0]["dominant"] in ("compute", "memory",
                                                      "collective")
    assert rows[0]["memory_t"] > 0 and rows[0]["collective_t"] > 0


def test_dryrun_parameter_bytes_are_the_local_blocks(dryrun_record):
    _parameter_bytes_are_the_local_blocks(dryrun_record["qwen2-7b"])


def test_dryrun_dot_flops_over_ranks_equal_the_unsharded(dryrun_record):
    _dot_flops_over_ranks_equal_the_unsharded(dryrun_record["qwen2-7b"])


def test_dryrun_record_feeds_the_roofline(dryrun_record, tmp_path):
    _record_feeds_the_roofline(dryrun_record["qwen2-7b"]["rec"], tmp_path)


# reduced qwen3-moe: the MoE layer's slot maps, dispatch and combine run
# on the mesh (its experts on the model axis)

def test_moe_dryrun_parameter_bytes_are_the_local_blocks(dryrun_record):
    _parameter_bytes_are_the_local_blocks(
        dryrun_record["qwen3-moe-235b-a22b"])


def test_moe_dryrun_dot_flops_over_ranks_equal_the_unsharded(dryrun_record):
    _dot_flops_over_ranks_equal_the_unsharded(
        dryrun_record["qwen3-moe-235b-a22b"])


def test_moe_dryrun_record_feeds_the_roofline(dryrun_record, tmp_path):
    _record_feeds_the_roofline(dryrun_record["qwen3-moe-235b-a22b"]["rec"],
                               tmp_path)
