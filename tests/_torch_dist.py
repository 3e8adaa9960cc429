"""Multi-rank groups for the parallel tests, on gloo over the CPU.

``launch(scenario, world, tmp)`` runs this file in one subprocess, which
spawns ``world`` ranks with ``torch.multiprocessing`` (the rank functions
live here, an importable module: a test function does not pickle across
pytest's import mode).  The ranks meet through a ``FileStore`` under
``tmp`` (no fixed port: the suite runs under xdist), each runs
``SCENARIOS[scenario](rank, world, tmp)`` on one torch thread, reads the
inputs the test left in ``tmp / "in.pt"`` and writes what it computed to
``tmp / f"out{rank}.pt"``; the process group is destroyed before the
rank exits, so none is ever left in a pytest worker.  The subprocess
has its own timeout and its process group of ranks is killed with it.
``start`` and ``finish`` split ``launch`` so that several groups run
side by side.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[1]


def launch(scenario: str, world: int, tmp, timeout: float = 240.0):
    """Run ``scenario`` on ``world`` ranks; returns the ranks' outputs."""
    return finish(start(scenario, world, tmp), timeout)


def start(scenario: str, world: int, tmp):
    """Start ``scenario`` on ``world`` ranks without waiting (groups started
    together run side by side); :func:`finish` collects it."""
    tmp = Path(tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT / "src"), str(_ROOT / "tests"),
         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, __file__, scenario, str(world), str(tmp)],
        env=env, cwd=str(_ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    return proc, scenario, world, tmp


def finish(started, timeout: float = 240.0):
    """The ranks' outputs of a group :func:`start` began."""
    proc, scenario, world, tmp = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{scenario}: {world} ranks timed out after "
                             f"{timeout} s\n{err[-3000:]}")
    if proc.returncode:
        raise AssertionError(f"{scenario} failed (rc {proc.returncode}):\n"
                             f"{out[-2000:]}\n{err[-6000:]}")
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, scenario: str, world: int, tmp: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = SCENARIOS[scenario](rank, world, Path(tmp))
        torch.save(out, Path(tmp) / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


def _inputs(tmp):
    return torch.load(Path(tmp) / "in.pt", weights_only=False)


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def sharded(rank, world, tmp):
    """The four sharded kernels, the two that refuse DTensors, and reduced
    qwen2-7b's forward/prefill/decode_step and one train step, on a
    (2, 2) mesh; the unsharded port runs beside it on every rank."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.convert import convert_params
    from repro_torch.models import model as M
    from torch.distributed.tensor import Replicate
    from repro_torch.parallel.api import place, place_tree, set_mesh
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    from repro_torch.tree import tree_map

    inp = _inputs(tmp)
    mesh = _mesh((2, 2))

    def on_mesh(args):      # replicated DTensors: the wrappers go sharded
        return [place(a, mesh, [Replicate()] * mesh.ndim)
                if isinstance(a, torch.Tensor) else a for a in args]
    out = {"kernels": {}, "model": {}}
    for name, (fn, args, kw) in inp["kernels"].items():
        wrapper = getattr(kernels, fn)
        kernels.reset_launch_counts()
        with set_mesh(mesh):
            got = wrapper(*on_mesh(args), **kw)
        got = tuple(t.full_tensor() for t in got) \
            if isinstance(got, tuple) else got.full_tensor()
        out["kernels"][name] = {
            "sharded": got, "plain": wrapper(*args, **kw),
            "bodies": kernels.sharded_launch_counts()[fn]}
    refusals = {}
    with set_mesh(mesh):
        for fn, args in inp["refusals"].items():
            try:
                getattr(kernels, fn)(*on_mesh(args))
                refusals[fn] = ""
            except ValueError as e:
                refusals[fn] = str(e)
    out["refusals"] = refusals

    tok, max_len, pos = inp["tokens"], inp["max_len"], inp["pos"]
    for kernels_on in (False, True):
        cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                                  dtype="float32", use_kernels=kernels_on)
        params = convert_params(inp["params"], device="cpu")
        dparams = place_tree(params, M.param_axes_rule, mesh)
        res = {}
        for tag, p, ctx in (("plain", params, set_mesh(None)),
                            ("sharded", dparams, set_mesh(mesh))):
            kernels.reset_launch_counts()
            with ctx:
                logits, _ = M.forward(cfg, p, {"tokens": tok})
                pl, cache = M.prefill(cfg, p, {"tokens": tok}, max_len)
                dl, cache = M.decode_step(cfg, p, cache, tok[:, :1], pos)
            full = (lambda t: t.full_tensor()) if tag == "sharded" \
                else (lambda t: t)
            res[tag] = {"forward": full(logits), "prefill": full(pl),
                        "decode": full(dl),
                        "k0": full(cache[0]["k"]),
                        "bodies": kernels.sharded_launch_counts()}
        out["model"][kernels_on] = res

    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              dtype="float32", use_kernels=False)
    opt_cfg = OptConfig(**inp["opt"])
    step = make_train_step(cfg, opt_cfg)
    params = convert_params(inp["params"], device="cpu")
    batch = inp["batch"]
    p1, o1, m1 = step(params, init_opt_state(params), batch)
    dparams = place_tree(params, M.param_axes_rule, mesh)
    dopt = place_tree(init_opt_state(params), M.param_axes_rule, mesh)
    with set_mesh(mesh):
        p2, o2, m2 = step(dparams, dopt, batch)

    def full(tree):
        return tree_map(lambda t: t.full_tensor() if hasattr(
            t, "full_tensor") else t, tree)
    out["train"] = {
        "plain": {"params": p1, "opt": o1, "metrics": m1},
        "sharded": {"params": full(p2), "opt": full(o2),
                    "metrics": full(m2)}}
    out["prefetch"] = _prefetched(inp["prefetch"], mesh)
    return out


def _prefetched(inp, mesh):
    """``prefetch_to_device(sharding=...)`` over ``inp["batches"]``, laid
    out by a per-leaf rule (``inp["specs"]``: name -> PartitionSpec
    entries, None for a plain leaf) and by one (mesh, placements) pair:
    each leaf's local block and placements (None for a plain tensor)."""
    from repro_torch.data import prefetch_to_device
    from repro_torch.parallel.api import (PartitionSpec, is_dtensor,
                                          to_placements)

    def layout(spec):
        return mesh, to_placements(PartitionSpec(*spec), mesh)

    def rule(name, t):
        spec = inp["specs"][name]
        return None if spec is None else layout(spec)
    out = {}
    for tag, sharding in (("rule", rule), ("pair", layout(inp["pair"]))):
        out[tag] = [
            {k: (v.to_local().clone(), [str(p) for p in v.placements])
             if is_dtensor(v) else (v, None) for k, v in b.items()}
            for b in prefetch_to_device(iter(inp["batches"]), size=1,
                                        device="cpu", sharding=sharding)]
    return out


def collectives(rank, world, tmp):
    """int8_psum over the world, and gpipe_apply over a 4-stage axis."""
    from repro_torch.parallel.compression import int8_psum
    from repro_torch.parallel.pipeline import gpipe_apply
    inp = _inputs(tmp)
    got = int8_psum(inp["x"][rank].clone())
    mesh = _mesh((world,), ("pod",))
    ws, x = inp["ws"], inp["micro"]
    pipe = gpipe_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh=mesh,
                       axis="pod")
    return {"psum": got, "gpipe": pipe}


def elastic(rank, world, tmp):
    """A checkpoint one process saved, restored onto a (4, 2) mesh laid
    out by the parameter rules."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel.api import named_sharding
    from repro_torch.perf.torch_graph import meta_params
    from repro_torch.train.checkpoint import restore
    from repro_torch.tree import flatten_with_path, tree_map
    mesh = _mesh((4, 2))
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              dtype="float32")
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                    meta_params(cfg))

    def key(path):
        return "::".join(p if isinstance(p, str) else f"#{p}" for p in path)

    rules = {key(path): (mesh, named_sharding(
        leaf.shape, M.param_axes_rule(path, leaf), mesh))
        for path, leaf in flatten_with_path(like)}
    restored, step = restore(tmp / "ckpt", like,
                             sharding_fn=lambda k, t: rules[k])
    out = {"step": step, "local": {}, "full": {}}
    for path, leaf in flatten_with_path(restored):
        out["local"][key(path)] = (tuple(leaf.to_local().shape),
                                   [getattr(p, "dim", None)
                                    for p in leaf.placements])
        out["full"][key(path)] = leaf.full_tensor()
    return out


def sharded_moe(rank, world, tmp):
    """Reduced f32 MoE models (``inp["archs"]``: name -> (config, the
    port's params)) on a (2, 2) mesh, or the one-rank (1, 1) mesh when
    ``world`` is 1: ``forward``, ``prefill`` and ``decode_step`` with the
    kernels off and on, sharded and unsharded, with the shard bodies each
    run took."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.models import model as M
    from repro_torch.parallel.api import place_tree, set_mesh

    inp = _inputs(tmp)
    mesh = _mesh((2, 2) if world == 4 else (1, 1))
    tok, max_len, pos = inp["tokens"], inp["max_len"], inp["pos"]
    out = {}
    for arch, (cfg, params) in inp["archs"].items():
        dparams = place_tree(params, M.param_axes_rule, mesh)
        for kernels_on in inp["kernels"]:
            c = dataclasses.replace(cfg, use_kernels=kernels_on)
            res = {}
            for tag, p, ctx in (("plain", params, set_mesh(None)),
                                ("sharded", dparams, set_mesh(mesh))):
                kernels.reset_launch_counts()
                with ctx:
                    logits, _ = M.forward(c, p, {"tokens": tok})
                    pl, cache = M.prefill(c, p, {"tokens": tok}, max_len)
                    dl, _ = M.decode_step(c, p, cache, tok[:, :1], pos)
                full = (lambda t: t.full_tensor()) if tag == "sharded" \
                    else (lambda t: t)
                res[tag] = {"forward": full(logits), "prefill": full(pl),
                            "decode": full(dl),
                            "bodies": kernels.sharded_launch_counts()}
            out[(arch, kernels_on)] = res
    return out


SCENARIOS = {"sharded": sharded, "sharded_moe": sharded_moe,
             "collectives": collectives, "elastic": elastic}


if __name__ == "__main__":
    import torch.multiprocessing as mp
    name, n, where = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_rank_main, args=(name, n, where), nprocs=n, join=True)
