"""The port's public API held to the reference's, module by module.

One fresh subprocess (this file run as a script) walks every module of
``repro`` that ``pkgutil.walk_packages`` finds, imports its twin under
``repro_torch`` and lists the gaps.  It must be a subprocess: importing
``repro.launch.dryrun`` writes ``XLA_FLAGS`` and ``REPRO_CPU_F32_DOTS``
into the environment, which would leak into the other test files of
the same worker.  For each module:

* every name in the reference's ``__all__`` (where it has none: its
  public top-level definitions, and the names a package's ``__init__``
  imports from the package) exists in the twin;
* every public class has the reference's public attributes and methods;
* every public callable's parameter names (a class's constructor, each
  method) include the reference's.

A name a module re-exports from another is checked for its members
where it is defined.

A gap is a string: ``"repro.kernels.compat"`` (a module with no twin),
``"repro.kernels:Decision"`` (a name), ``"repro.models.config:
ModelConfig.use_pallas"`` (an attribute or method) or
``"repro.models.attention:init_attn(key)"`` (a parameter; a class's
constructor ``Class(name)``, a method ``Class.method(name)``).

``DIFFERENCES`` is the one table of deliberate differences, each with
its reason.  A module's gaps must be its entries exactly: a gap outside
the table fails, and so does an entry that is no longer a gap.  So a new
public name in either package needs its twin, or an entry here with a
reason.  ``repro.fleet.__main__`` runs its CLI when imported: the walk
checks that its twin exists without importing it.

The gaps this table once held, ported and held against the reference
below: the planner's names re-exported from ``repro_torch.kernels``; the
model configuration's specs and ``param_logical_axes`` re-exported from
``repro_torch.models``; ``init_attn_cache`` and ``init_mla_cache``'s
``dtype``; ``prefetch_to_device``'s ``sharding`` (on a 4-rank gloo mesh
in ``tests/test_torch_sharded.py``).
"""

import ast
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro"

_DISPATCH = ("the reference's per-op kernel-or-fallback dispatch: the port "
             "raises where the reference falls back, and its launch counts "
             "show that a kernel ran")
_TILES = ("a Pallas tile or interpret mode: each CUDA kernel fixes its own "
          "tiles and masks ragged shapes itself")
_KEY = ("jax's PRNG key: the port draws from an explicit torch.Generator "
        "(gen, generator)")
_FLAG = ("the Pallas switch and its device: the port's use_kernels picks "
         "the CUDA kernels, on the tensors' own device")
_POOLS = ("a functional cache: the port writes its pools in place (pools) "
          "and returns only the logits")

DIFFERENCES = {
    "repro.kernels.compat": "Pallas and TPU version shims; the port has no "
                            "Pallas",
    "repro.kernels.dispatch": _DISPATCH,
    "repro.kernels.ops": "the Pallas wrappers (zero-padding onto tiles, "
                         "shard_map): the CUDA kernels mask ragged shapes, "
                         "DTensor operands take repro_torch.kernels.sharded",
    **{f"repro.kernels:{n}": _DISPATCH
       for n in ("Decision", "decide", "decision_scope", "fallback",
                 "last_decisions", "reset_decisions")},
    "repro.fleet.capacity:hlo_graphs": "compiles the reference's steps "
                                       "through XLA; the port captures its "
                                       "own with torch_graphs",
    **{f"repro.kernels.{mod}:{fn}({p})": _TILES
       for mod, fn, params in (
           ("decode_attention", "decode_attention", ("block_kv",
                                                     "interpret")),
           ("decode_attention", "paged_decode_attention", ("interpret",)),
           ("flash_attention", "flash_attention", ("block_q", "block_kv",
                                                   "interpret")),
           ("mamba2_ssd", "mamba2_ssd", ("chunk", "interpret")),
           ("mfma_gemm", "mfma_gemm", ("block_m", "block_n", "block_k",
                                       "interpret")),
           ("moe_gmm", "moe_gmm", ("block_m", "block_n", "block_k",
                                   "interpret")))
       for p in params},
    **{f"repro.models.{mod}:{fn}(key)": _KEY
       for mod, fn in (("attention", "init_attn"), ("attention", "init_mla"),
                       ("attention", "init_cross"), ("blocks", "init_layer"),
                       ("blocks", "init_mlp"), ("model", "init_params"),
                       ("moe", "init_moe"), ("ssm", "init_ssm"))},
    **{"repro.models." + where.format(p): _FLAG
       for where in ("attention:attention({})", "ssm:ssd_chunked({})",
                     "config:ModelConfig({})", "config:ModelConfig.{}")
       for p in ("use_pallas", "pallas_device")},
    "repro.models.layers:mm(subscripts)": "an einsum string: the port's mm "
                                          "is a broadcasting matmul",
    "repro.models.model:paged_decode_step(cache)": _POOLS,
    "repro.models.model:paged_prefill_step(cache)": _POOLS,
    "repro.parallel.compression:int8_psum(axis_name)": "a named mesh axis: "
                                                       "the port reduces "
                                                       "over a "
                                                       "torch.distributed "
                                                       "group (group)",
    "repro.serve.paged_cache:default_page_size(device)": "a TPU tile's "
                                                         "page: the port "
                                                         "fixes a Hopper "
                                                         "page",
}


def _module_of(gap: str) -> str:
    return gap.split(":")[0]


# -- the walk (run in a subprocess) ------------------------------------------

def _definitions(mod):
    """Public top-level definitions of a module without ``__all__``; in a
    package's ``__init__`` also the names it imports from the package."""
    path = getattr(mod, "__file__", None)
    if not path:
        return []
    package = path.endswith("__init__.py")
    names = []
    for node in ast.parse(Path(path).read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
        elif package and isinstance(node, ast.ImportFrom) and (
                node.level or (node.module or "").startswith("repro")):
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _callable_gaps(prefix, ref, twin):
    want = _params(ref)
    if want is None:
        return []
    got = _params(twin)
    if got is None:
        return [f"{prefix}(signature)"]
    return [f"{prefix}({p})" for p in want if p not in got]


def _module_gaps(name, ref, twin):
    gaps = []
    names = list(ref.__all__) if hasattr(ref, "__all__") \
        else _definitions(ref)
    for n in names:
        r = getattr(ref, n)
        if not hasattr(twin, n):
            gaps.append(f"{name}:{n}")
            continue
        t = getattr(twin, n)
        if inspect.ismodule(r) or getattr(r, "__module__", name) != name:
            continue            # a module, or a re-export checked at home
        if inspect.isclass(r):
            gaps += _callable_gaps(f"{name}:{n}", r, t)
            for a in dir(r):
                if a.startswith("_"):
                    continue
                if not hasattr(t, a):
                    gaps.append(f"{name}:{n}.{a}")
                elif callable(getattr(r, a)):
                    gaps += _callable_gaps(f"{name}:{n}.{a}", getattr(r, a),
                                           getattr(t, a))
        elif callable(r):
            gaps += _callable_gaps(f"{name}:{n}", r, t)
    return gaps


def _walk():
    """``{"modules": [...], "gaps": {module: [gap, ...]}}``."""
    import pkgutil
    import repro
    modules = [m.name for m in pkgutil.walk_packages(repro.__path__,
                                                     "repro.")]
    gaps = {}
    for name in modules:
        twin_name = "repro_torch" + name[len("repro"):]
        if name.endswith(".__main__"):
            if importlib.util.find_spec(twin_name) is None:
                gaps[name] = [name]
            continue
        ref = importlib.import_module(name)
        try:
            twin = importlib.import_module(twin_name)
        except ModuleNotFoundError as e:
            if e.name != twin_name:
                raise
            gaps[name] = [name]
            continue
        found = _module_gaps(name, ref, twin)
        if found:
            gaps[name] = found
    return {"modules": modules, "gaps": gaps}


# -- the tests ----------------------------------------------------------------

def _reference_modules():
    """Every module under ``src/repro``, named from the files."""
    out = []
    for path in sorted(REFERENCE.rglob("*.py")):
        parts = path.relative_to(REFERENCE.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if len(parts) > 1:          # ``repro`` itself is a namespace
            out.append(".".join(parts))
    return out


MODULES = _reference_modules()


@pytest.fixture(scope="module")
def walk():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env.setdefault("JAX_PLATFORMS", "cpu")
    done = subprocess.run([sys.executable, __file__], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_walk_finds_every_module(walk):
    assert sorted(walk["modules"]) == sorted(MODULES)


def test_every_table_entry_names_a_walked_module():
    stale = sorted(g for g in DIFFERENCES if _module_of(g) not in MODULES)
    assert not stale, stale


@pytest.mark.parametrize("module", MODULES)
def test_module_matches_reference(walk, module):
    got = set(walk["gaps"].get(module, []))
    want = {g for g in DIFFERENCES if _module_of(g) == module}
    assert not got - want, f"gaps outside the table: {sorted(got - want)}"
    assert not want - got, f"table entries no longer gaps: " \
                           f"{sorted(want - got)}"


PLANNER = ("KernelEntry", "TilePlan", "UnknownKernelError", "get_kernel",
           "list_kernels", "plan_for", "register_kernel")


def test_kernels_package_exports_the_planner():
    """The seven planner names of ``repro.kernels`` are the port's
    ``kernels.plan`` objects, and plan as the reference's do on its
    devices."""
    import repro.kernels as jk
    import repro_torch.kernels as tk
    from repro_torch.kernels import plan
    for n in PLANNER:
        assert n in jk.__all__ and n in tk.__all__
        assert getattr(tk, n) is getattr(plan, n)
    assert sorted(jk.list_kernels()) == sorted(tk.list_kernels())
    shapes = {"E": 8, "C": 256, "K": 512, "N": 384}
    for device in ("tpu_v5e", "mi300x"):
        want = jk.plan_for("moe_gmm", shapes, device=device)
        got = tk.plan_for("moe_gmm", shapes, device=device)
        assert got.blocks == want.blocks
    with pytest.raises(tk.UnknownKernelError):
        tk.get_kernel("no_such_kernel")


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("arch,fn", [("qwen2-7b", "init_attn_cache"),
                                     ("deepseek-v2-lite-16b",
                                      "init_mla_cache")])
def test_cache_dtype_matches_reference(arch, fn, dtype):
    """``dtype`` None gives ``cfg.dtype``; a name gives that type; the
    leaves and shapes are the reference's."""
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jax_get_config
    from repro.models import attention as jax_attn
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    want = getattr(jax_attn, fn)(jcfg, 2, 24, None if dtype is None
                                 else jnp.dtype(dtype))
    got = getattr(attn, fn)(cfg, 2, 24, dtype, device="cpu")
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not got[k].any()
    typed = getattr(attn, fn)(cfg, 1, 4, torch.float16, device="cpu")
    assert {t.dtype for t in typed.values()} == {torch.float16}


if __name__ == "__main__":
    print(json.dumps(_walk()))
