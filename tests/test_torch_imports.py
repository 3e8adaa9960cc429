"""Import guard: the port and chip_smoke.py never load jax or the
reference package, and entry points never fall back to the CPU."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
sys.path.insert(0, sys.argv[1] + "/src")
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", sys.argv[1] + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_and_chip_smoke_never_import_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in ("repro_torch.kernels.decode_attention",
                "repro_torch.kernels.flash_attention",
                "repro_torch.serve.paged_engine", "repro_torch.serve.engine",
                "repro_torch.convert", "repro_torch.models.attention",
                "repro_torch.configs.deepseek_v2_lite_16b",
                "repro_torch.configs.llama_3_2_vision_90b",
                "repro_torch.configs.whisper_base",
                "repro_torch.configs.internlm2_20b",
                "repro_torch.configs.mistral_nemo_12b",
                "repro_torch.configs.yi_34b"):
        assert mod in got["modules"]


_STUDY_PROBE = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location(
    "torch_sync_study", sys.argv[1] + "/scripts/torch_sync_study.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import repro_torch.serve, repro_torch.models
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"leaked": leaked, "main": callable(mod.main)}))
"""


def test_sync_study_script_never_imports_jax_or_reference():
    """``scripts/torch_sync_study.py`` runs on the card beside
    chip_smoke.py: loading it, and the port it drives, loads no jax."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _STUDY_PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "main": True}


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import PagedKVCache, PagedServeEngine, ServeEngine
    cfg = get_config("qwen2-7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PagedServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(cfg, n_blocks=3)
    with pytest.raises(RuntimeError, match="requested"):
        init_params(cfg, torch.Generator().manual_seed(0))


def test_moe_modules_import_clean():
    """The MoE slice's modules are part of the walk above and load
    neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in ("repro_torch.models.moe", "repro_torch.kernels.moe_gmm",
                "repro_torch.configs.qwen3_moe_235b_a22b"):
        assert mod in got["modules"]


def test_ssm_modules_import_clean():
    """The SSM slice's modules are part of the walk above and load
    neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in ("repro_torch.models.ssm", "repro_torch.kernels.mamba2_ssd",
                "repro_torch.configs.mamba2_370m",
                "repro_torch.configs.jamba_v0_1_52b"):
        assert mod in got["modules"]


def test_ssm_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache
    cfg = get_config("mamba2-370m").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)


def test_mfma_contract_modules_import_clean():
    """The MFMA contract slice's modules are part of the walk above and
    load neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in ("repro_torch.core.isa", "repro_torch.core.functional",
                "repro_torch.arch.spec", "repro_torch.arch.registry",
                "repro_torch.kernels.mfma_gemm"):
        assert mod in got["modules"]


def test_mfma_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.core.functional import mfma_apply, random_operands
    a, b, c = random_operands("fp32_16x16x4fp32", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_operands("fp32_16x16x4fp32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mfma_apply("fp32_16x16x4fp32", a.numpy(), b.numpy(), c.numpy())


_EXAMPLE_PROBE = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
spec = importlib.util.spec_from_file_location(
    "torch_train_lm", sys.argv[1] + "/examples/torch_train_lm.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"leaked": leaked, "main": callable(mod.main)}))
"""


def test_training_modules_and_example_import_clean():
    """The training slice's modules are part of the walk above, and the
    training example loads neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in ("repro_torch.train", "repro_torch.train.optim",
                "repro_torch.train.step", "repro_torch.train.checkpoint",
                "repro_torch.train.fault_tolerance",
                "repro_torch.tree", "repro_torch.data",
                "repro_torch.data.pipeline"):
        assert mod in got["modules"]
    out = subprocess.run([sys.executable, "-c", _EXAMPLE_PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "main": True}


def test_training_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.data import prefetch_to_device
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch_to_device(iter(()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.train("smoke", steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--steps", "1"])


TIMING_MODULES = ("repro_torch.arch.overlay", "repro_torch.arch.select",
                  "repro_torch.arch.registry", "repro_torch.arch",
                  "repro_torch.core.program", "repro_torch.core.machine",
                  "repro_torch.core.scoreboard",
                  "repro_torch.core.microbench", "repro_torch.core.whatif",
                  "repro_torch.core.isa", "repro_torch.core")

_FIRST_PROBE = r"""
import importlib, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch  # noqa: F401  (kept loaded; only the port is re-imported)
ok = {}
for name in sys.argv[2:]:
    for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[m]
    try:
        importlib.import_module(name)
        ok[name] = True
    except Exception as e:  # an import cycle shows up here
        ok[name] = f"{type(e).__name__}: {e}"
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"ok": ok, "leaked": leaked}))
"""


def test_timing_modules_import_clean_and_first():
    """The timing model's and the probe's modules are part of the walk
    above, and each one imports cleanly when it is the first of the
    port imported (arch.spec, core.isa and core.machine import each
    other lazily: a cycle would break one of these orders)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in TIMING_MODULES + ("repro_torch.kernels.listing1",):
        assert mod in got["modules"]
    names = TIMING_MODULES + ("repro_torch.arch.spec",
                              "repro_torch.kernels.listing1",
                              "repro_torch.kernels")
    out = subprocess.run([sys.executable, "-c", _FIRST_PROBE, str(ROOT),
                          *names], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ok": {n: True for n in names}, "leaked": []}


def test_timing_modules_are_pure_python():
    """The timing modules import neither torch nor jax themselves, as in
    the reference; only the probe's wrapper imports torch."""
    import ast
    for name in TIMING_MODULES:
        path = ROOT / "src" / (name.replace(".", "/") + (
            "/__init__.py" if name.count(".") == 1 else ".py"))
        imported = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                imported.add(node.module.split(".")[0])
        assert not imported & {"torch", "jax", "jaxlib", "numpy", "repro"}, \
            (name, imported)


_WHATIF_PROBE = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
spec = importlib.util.spec_from_file_location(
    "torch_whatif_analysis",
    sys.argv[1] + "/examples/torch_whatif_analysis.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"leaked": leaked, "main": callable(mod.main)}))
"""

PERF_MODULES = ("repro_torch.perf", "repro_torch.perf.hlo_ir",
                "repro_torch.perf.report", "repro_torch.perf.cache",
                "repro_torch.perf.engines", "repro_torch.perf.pipeline",
                "repro_torch.perf.torch_graph", "repro_torch.kernels.plan",
                "repro_torch.core.hlo_bridge",
                "repro_torch.core.hlo_analysis")


def test_perf_modules_and_example_import_clean():
    """The perf pipeline's modules (walked by the first test above) each
    import cleanly as the first of the port, and the what-if example
    loads neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _FIRST_PROBE, str(ROOT),
                          *PERF_MODULES], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ok": {n: True for n in PERF_MODULES}, "leaked": []}
    out = subprocess.run([sys.executable, "-c", _WHATIF_PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "main": True}


_FLEET_PROBE = r"""
import importlib, importlib.util, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
mods = {}
for name in ("repro_torch.fleet", "repro_torch.fleet.__main__",
             "repro_torch.fleet.scenario", "repro_torch.fleet.capacity",
             "repro_torch.fleet.frontier", "repro_torch.fleet.cli"):
    mods[name] = importlib.import_module(name).__name__ == name
spec = importlib.util.spec_from_file_location(
    "torch_fleet_planning", sys.argv[1] + "/examples/torch_fleet_planning.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"leaked": leaked, "mods": mods, "main": callable(mod.main)}))
"""


def test_fleet_modules_and_example_import_clean():
    """The fleet planner, its ``__main__`` (imported without running the
    CLI) and the fleet example load neither jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _FLEET_PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == [] and got["main"] is True
    assert got["mods"] and all(got["mods"].values())


PARALLEL_MODULES = ("repro_torch.parallel", "repro_torch.parallel.api",
                    "repro_torch.parallel.compression",
                    "repro_torch.parallel.pipeline",
                    "repro_torch.kernels.sharded", "repro_torch.launch",
                    "repro_torch.launch.mesh", "repro_torch.launch.specs",
                    "repro_torch.launch.dryrun", "repro_torch.launch.roofline")

_ENV_PROBE = r"""
import importlib, json, os, sys
sys.path.insert(0, sys.argv[1] + "/src")
import repro_torch.launch
env = {k: os.environ.get(k) for k in ("XLA_FLAGS", "REPRO_CPU_F32_DOTS")}
for name in sys.argv[2:]:
    importlib.import_module(name)
env_after = {k: os.environ.get(k) for k in env}
print(json.dumps({"env": env, "env_after": env_after}))
"""


def test_parallel_and_launch_modules_import_clean_and_first():
    """The parallel and launch slice's modules are part of the walk above
    and each imports cleanly as the first of the port; importing
    ``repro_torch.launch`` (or any launch module) writes no
    ``XLA_FLAGS`` or ``REPRO_CPU_F32_DOTS``, where the reference's
    dry-run module writes both."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "REPRO_CPU_F32_DOTS")}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    for mod in PARALLEL_MODULES:
        assert mod in got["modules"]
    out = subprocess.run([sys.executable, "-c", _FIRST_PROBE, str(ROOT),
                          *PARALLEL_MODULES], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ok": {n: True for n in PARALLEL_MODULES}, "leaked": []}
    out = subprocess.run([sys.executable, "-c", _ENV_PROBE, str(ROOT),
                          *PARALLEL_MODULES], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    unset = {"XLA_FLAGS": None, "REPRO_CPU_F32_DOTS": None}
    assert got == {"env": unset, "env_after": unset}


TWINS = ("examples/torch_serve_demo.py", "examples/torch_serve_resilience.py",
         "examples/torch_quickstart.py",
         "scripts/torch_check_device_specs.py", "scripts/torch_memdebug.py")

_TWIN_PROBE = r"""
import importlib.util, json, pathlib, sys
sys.path.insert(0, sys.argv[1] + "/src")
mains = {}
for rel in sys.argv[2:]:
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(rel).stem, sys.argv[1] + "/" + rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mains[rel] = callable(mod.main)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"leaked": leaked, "mains": mains}))
"""


def test_example_and_script_twins_import_clean():
    """The twins of the reference's serve demo, resilience and quickstart
    examples, its device-spec lint and its memdebug script load neither
    jax nor the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _TWIN_PROBE, str(ROOT),
                          *TWINS], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "mains": {d: True for d in TWINS}}


def test_near_tie_calibration_script_imports_clean():
    """``scripts/torch_near_tie_calibration.py`` (the near-tie rule's
    calibration, run on the CPU and on the card) loads neither jax nor
    the reference."""
    script = "scripts/torch_near_tie_calibration.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _TWIN_PROBE, str(ROOT),
                          script], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "mains": {script: True}}


@pytest.mark.parametrize("example", TWINS[:3])
def test_example_twins_default_to_cuda(monkeypatch, example):
    spec = importlib.util.spec_from_file_location(
        Path(example).stem, ROOT / example)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
