"""The port's twins of the reference's examples and scripts, on the CPU
at their smallest flags: the serve demo, the resilience demo and the
quickstart (``examples/torch_*.py``, the kernel path's plain versions),
the device-spec lint and memdebug (``scripts/torch_*.py``).

* Each example prints the reference's fields.  The serve demo's trace is
  the reference's ``make_requests`` trace for the same seed; the
  resilience demo's act 3 holds its recomputed streams to the fault-free
  run by the near-tie rule and reclaims the whole pool.
* The lint passes the six devices of ``repro_torch.arch``, gives the
  reference's ``check_spec`` result (no violation) on the reference's
  five, and flags two broken copies of the H100: an advertised peak 10x
  its tensor-core rate, and a shared memory below the ``wgmma`` ring.
* memdebug's bytes by (aten op, site) on a reduced cell sum to the
  dry-run recorder's total (run in a subprocess: its ``fake`` process
  group must not outlive it in a pytest worker).
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.arch import get_device, list_devices

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread: the examples run thousands of small ops,
    and beside the suite's other workers a pool as wide as the machine
    makes each op wait on threads they hold (the resilience demo: 5 s on
    one thread, 48 s on eight beside a loaded machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        Path(rel).stem + "_under_test", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def lint():
    return _load("scripts/torch_check_device_specs.py")


def test_serve_demo_trace_equals_the_references():
    mine = _load("examples/torch_serve_demo.py")
    ref = _load("examples/serve_demo.py")
    for n, max_len in ((12, 128), (30, 64)):
        a = mine.make_requests(np.random.default_rng(0), 512, n, max_len)
        b = ref.make_requests(np.random.default_rng(0), 512, n, max_len)
        assert [(r.n_steps, r.arrival) for r in a] == \
            [(r.n_steps, r.arrival) for r in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.prompt, np.asarray(y.prompt))
            assert x.prompt.dtype == np.int32


@pytest.mark.parametrize("arch,engine", [("qwen2-7b", "paged"),
                                         ("mamba2-370m", "bucket")])
def test_serve_demo_prints_the_references_fields(arch, engine):
    out = _run(_load("examples/torch_serve_demo.py"),
               ["--device", "cpu", "--arch", arch, "--requests", "2",
                "--max-len", "48"])
    lines = out.splitlines()
    if engine == "paged":
        assert lines[0].startswith(f"arch={arch}-smoke: 2 ragged requests")
        assert "page=48" in lines[0] and "pool=" in lines[0]
        assert lines[1].startswith("wall=") and "decode steps over" in \
            lines[1] and "peak occupancy" in lines[1]
        assert lines[2].startswith("req0: prompt=") and "admitted@" in \
            lines[2]
    else:
        assert lines[0].startswith(f"arch={arch}-smoke: not pageable")
        assert lines[1].startswith("2 requests,") and "bucketed" in lines[1]
        assert lines[2].startswith("req0: [")


def test_serve_resilience_acts_and_act3_near_tie_rule():
    out = _run(_load("examples/torch_serve_resilience.py"),
               ["--device", "cpu", "--requests", "2"])
    assert out.startswith("overload trace: 2 requests in bursts")
    for head in ("[1] unbounded FIFO queue", "[2] max_queue=4",
                 "[3] fault injection"):
        assert head in out
    for field in ("naive:", "graceful:", "chaos:", "ticks=", "preemptions=",
                  "stalled_ticks="):
        assert field in out
    assert "float32-arbitrated near-tie rule: held" in out
    assert "pool fully reclaimed: True" in out


def test_quickstart_prints_the_references_rows():
    out = _run(_load("examples/torch_quickstart.py"),
               ["--device", "cpu", "--steps", "2"])
    assert out.startswith("arch=qwen2-7b-smoke (family=dense)")
    for field in ("params: ", "step   0  loss=", "step   1  loss=",
                  "prompt :", "decoded:",
                  "what-if: one train step, unified repro_torch.perf"):
        assert field in out
    rows = [line.split() for line in out.splitlines() if line.startswith("  ")]
    assert [r[:2] for r in rows] == [["mi300", "mfma"],
                                     ["mi300", "scoreboard"],
                                     ["tpu_v5e", "roofline"],
                                     ["h100", "roofline"], ["mi300", "mfma"]]
    assert all(float(r[2].removesuffix("us")) > 0 for r in rows)
    assert rows[-1][-3:] == ["[2x", "faster", "MCE]"]
    decoded = out.split("decoded:")[1].splitlines()[0]
    assert len(json.loads(decoded)) == 12


def test_lint_passes_every_device(lint):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert lint.main() == 0
    assert buf.getvalue().strip().endswith("+ fleet frontiers: OK")
    assert "h100" in buf.getvalue()


def test_lint_equals_the_references_on_its_devices(lint):
    ref = _load("scripts/check_device_specs.py")
    from repro.arch import list_devices as jax_list_devices
    names = set(jax_list_devices())
    assert names == set(list_devices()) - {"h100"}
    for name in sorted(names):
        assert lint.check_spec(name) == ref.check_spec(name) == []


@pytest.mark.parametrize("broken,needle", [
    (lambda h: dataclasses.replace(h, peak_flops=10 * h.peak_flops),
     ">4x off the dense bf16 tensor-core rate"),
    (lambda h: dataclasses.replace(h, vmem_bytes=150_000),
     "cannot hold the mfma_gemm wgmma ring"),
], ids=["peak_10x", "vmem_below_ring"])
def test_lint_flags_a_broken_h100(lint, broken, needle):
    errs = lint.check_spec("h100", broken(get_device("h100")))
    assert len(errs) == 1 and needle in errs[0], errs


_MEMDEBUG = textwrap.dedent("""
    import dataclasses, importlib.util, json, sys
    spec = importlib.util.spec_from_file_location("torch_memdebug",
                                                  sys.argv[2])
    md = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(md)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_smoke_mesh
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              use_kernels=False)
    with fake_world(8):
        mesh = make_smoke_mesh((4, 2), device="cpu")
        rec, rows, total = md.byte_movers("qwen2-7b", "decode_32k",
                                          cfg=cfg, mesh=mesh)
    json.dump({"rec": rec, "total": total,
               "rows": [[k[0], k[1], k[2], b] for k, b in rows.items()],
               "report": md.report(rec, rows, total, 5)},
              open(sys.argv[1], "w"))
""")


def test_memdebug_bytes_by_op_and_site_sum_to_the_total(tmp_path):
    out = tmp_path / "md.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _MEMDEBUG, str(out),
                          str(ROOT / "scripts" / "torch_memdebug.py")],
                         capture_output=True, text=True, cwd=str(ROOT),
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(out.read_text())
    total = sum(b for *_, b in got["rows"])
    assert total == got["total"] == got["rec"]["hlo"]["bytes_per_device"]
    sites = {site for _, site, _, _ in got["rows"]}
    assert "models.attention._qkv" in sites and "models.layers.mlp_apply" \
        in sites
    assert all(s.startswith(("models.", "train.", "(outside"))
               for s in sites), sites
    assert any(core for _, _, core, _ in got["rows"])
    assert got["report"][0].startswith("qwen2-7b decode_32k on 4x2 "
                                       "(8 devices), per device: args=")
