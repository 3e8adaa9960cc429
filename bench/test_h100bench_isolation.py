"""The benchmark loads neither JAX nor the JAX package, reads nothing
under ``benchmarks/``, and refuses to run without a card.

A subprocess runs one cell's whole chain at a size the CPU holds (the
harness, the port's engine, the weights, the reference, every metric
reader and count) with an audit hook recording every file it opens;
then the loaded modules' top-level names are compared, whole, with
``jax``, ``jaxlib``, ``flax`` and ``repro`` (``repro_torch`` is not
``repro``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

CHAIN = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
sys.path[:0] = [sys.argv[1] + "/bench", sys.argv[1] + "/src"]
from h100bench import harness
tiny = {"config": {"hidden_size": 64, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 32,
                   "num_hidden_layers": 2, "vocab_size": 256,
                   "num_experts": 8, "num_experts_per_tok": 2,
                   "moe_intermediate_size": 32},
        "traffic": {"initial": 4, "rate_per_tick": 0.5,
                    "prompt": {"dist": "loguniform", "min": 4, "max": 40},
                    "output": {"dist": "uniform", "min": 3, "max": 12}},
        "workload": {"engine": {"max_batch": 4, "max_len": 64, "page": 16,
                                "prefill_chunk": 16, "n_blocks": None},
                     "start_step": 3, "trace_seconds": 0.3}}
for traced in (False, True):
    harness.run_cell("qwen3-moe-8l.chat", 3, 0.5, traced, t_start=0.0,
                     device="cpu", overrides=tiny)
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": harness.forbidden_modules(),
                  "opened": opened}))
"""


def test_a_run_loads_no_jax_and_reads_no_benchmarks_folder():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", CHAIN, str(ROOT)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert "repro_torch" in out["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["modules"])
    assert out["forbidden"] == []
    bad = [f for f in out["opened"]
           if "/benchmarks/" in f or f.endswith("/benchmarks")]
    assert bad == []
    assert any(f.endswith(".py") and "/bench/metrics/" in f
               for f in out["opened"])


def test_forbidden_modules_compares_whole_top_level_names():
    sys.path.insert(0, str(BENCH))
    from h100bench import harness
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serve", "jaxtyping", "flaxen",
         "reprocess"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.models", "jax._src.core", "jaxlib",
         "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line; ``run_cell`` on ``cuda`` raises instead of falling back
    to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "qwen2-7b.longdoc", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
    check = ("import sys; sys.path[:0] = ['bench', 'src'];"
             "from h100bench import harness\n"
             "try:\n"
             "    harness.run_cell('qwen2-7b.longdoc', 1, 1.0, False,"
             " t_start=0.0)\n"
             "except RuntimeError as e:\n"
             "    print('raised', e)\n")
    p = subprocess.run([sys.executable, "-c", check], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.stdout.startswith("raised"), p.stdout + p.stderr[-2000:]


def test_a_folder_of_the_benchmark_alone_does_not_run(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and ``bench/`` has no
    program to run: the command exits non-zero with no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "qwen3-moe-8l.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
