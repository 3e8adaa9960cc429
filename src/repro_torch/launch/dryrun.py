"""Multi-pod dry-run of every (arch x shape x mesh) cell on a fake process
group (twin of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads the compiled per-device module.  The port runs the
cell's function once on meta-device DTensors over a ``fake`` process
group of 256 (``16x16``) or 512 (``2x16x16``) ranks in one process
(``torch.testing._internal.distributed.fake_pg.FakeStore``): shapes,
placements and every collective DTensor issues are real, no value is
computed, and nothing is allocated.  For each cell it:

  1. builds the production mesh (:mod:`~repro_torch.launch.mesh`),
  2. builds abstract, sharded inputs (:mod:`~repro_torch.launch.specs`),
  3. runs the function under ``set_mesh`` with two recorders: a
     ``TorchDispatchMode`` that sees the *local* ops and DTensor's
     functional collectives, and ``CommDebugMode``, which counts the
     collectives,
  4. records per-device bytes, FLOPs and collective wire bytes to JSON
     under the reference's keys, so ``roofline_row`` reads both packages'
     records.

**Local capture.**  A dispatch mode above DTensor sees global ops.  The
recorder returns ``NotImplemented`` for any op with a DTensor operand, so
DTensor's own dispatch runs it and issues the local ops, which the
recorder then sees on the local (per-device) blocks.  Ops whose operands
are ``FakeTensor``s are DTensor's shape propagation (global shapes) and
are not counted.  The local ops are counted by
:mod:`repro_torch.perf.torch_graph`'s rules (dots by site, bytes per aten
opcode, the attention core's intermediates as ``flash_block_bytes``);
each ``_c10d_functional`` collective becomes a ``"collective"`` op with
its result bytes and its ring-model wire bytes by
:mod:`repro_torch.perf.hlo_ir`'s rules (group size from its process
group).

**Memory.**  ``argument_size_in_bytes`` and ``output_size_in_bytes`` are
the local blocks' bytes of the inputs and outputs; ``alias_size_in_bytes``
is the outputs that are inputs written in place (the decode cache; the
port's train step returns new parameters and state, so it aliases
nothing, where the reference donates them).  XLA's
``temp_size_in_bytes`` (the compiled program's scratch) has no
counterpart in an eager run: the record states this under
``memory["not_measured"]`` and leaves it out, so
``total_bytes_per_device`` (arguments + outputs - aliases) counts the
state and the results, not the activations in flight.

**Sites without a DTensor sharding rule.**  None of the cells' ops is
turned into a plain tensor.  These sites are handled explicitly:

* plain tensors the model makes beside DTensors (positions, masks, RoPE
  frequencies, index vectors) are replicated by ``implicit_replication``,
  which ``set_mesh`` enters;
* ``aten.mm.dtype`` (the bf16 product with an f32 output) gets
  ``aten.mm``'s rule (``parallel.api.register_rules``);
* the cache writes of the decode steps and the prefill's padded caches
  (``parallel.api.write_rows``, ``assign``) run on each rank's local
  block, after laying the new rows out like the cache;
* the attention core for S > 1 (``models.attention._attention_on_shards``),
  the MoE slot maps (``models.moe._slot_maps``: DTensor's in-place
  scatter into a plain tensor fails), the embedding lookup
  (``models.layers._lookup_on_shards``: the gradient's ``index_put``
  has a faulty rule on torch 2.11) and the kernels
  (:mod:`repro_torch.kernels.sharded`) run under ``local_map`` on
  explicit placements; the cells here run the plain path
  (``use_kernels=False``), as the reference's lower its
  ``use_pallas=False`` path;
* the MoE expert products fold the batch groups into each expert's rows
  (and back) through a contiguous copy, forward and backward
  (``models.moe._Relayout``): a redistribute can leave a DTensor's
  strides unlike its local block's, and the view then fails;
* layouts the model sets at a ``shard()`` site: a projection's output is
  laid out on whole heads before it is viewed as heads (or replicated
  when the head count does not divide the model axis), and so is the
  attention output before its heads are merged; a product gathers any
  split batch dim but the first before it folds them, and lays out the
  gradient of its output so too (``models.layers._foldable``; torch
  2.11 will not view two split dims as one); the mid-layer residual and
  decode's layer boundary are laid out like the reference's layer
  boundary, so no partial sum reaches a product with a gathered weight.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh both --out DIR
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs import SHAPES, all_cells, applicable, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import cell_fn_and_specs
from repro_torch.parallel.api import set_mesh
from repro_torch.perf.hlo_ir import KernelOp, _wire_bytes
from repro_torch.perf.torch_graph import _nbytes, _on_chip_regions, _Recorder
from repro_torch.tree import leaves

__all__ = ["run_cell", "main", "fake_world", "NOT_MEASURED"]

#: The functional collectives DTensor issues -> HLO's collective names.
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all"}

NOT_MEASURED = ("temp_size_in_bytes: XLA's compiled scratch has no "
                "counterpart in an eager run on meta tensors; "
                "total_bytes_per_device leaves it out")


class _LocalRecorder(_Recorder):
    """torch_graph's recorder beneath DTensor: DTensor ops pass through to
    DTensor's dispatch, shape propagation on FakeTensors is not counted,
    and functional collectives become collective ops."""

    def __init__(self):
        super().__init__()
        self.collectives: "OrderedDict[tuple, list]" = OrderedDict()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, FakeTensor) for a in flat):
            return func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            out = func(*args, **kwargs)
            kind = _COLLECTIVES.get(func.overloadpacket.__name__)
            if kind is not None:
                self._collective(kind, args, out)
            return out
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _collective(self, kind: str, args, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = next(a for a in reversed(args) if isinstance(a, str))
        g = _resolve_process_group(name).size()
        nbytes = float(_nbytes(out))
        key = (kind, g, nbytes)
        site = self.collectives.setdefault(key, [KernelOp(
            kind="collective", opcode=kind, bytes=nbytes,
            wire_bytes=_wire_bytes(kind, nbytes, g), group=g), 0])
        site[1] += 1

    def graph(self):
        graph = super().graph()
        coll = [dataclasses.replace(op, count=float(n))
                for op, n in self.collectives.values()]
        graph.ops = graph.ops + coll
        graph.collective_wire = float(sum(op.count * op.wire_bytes
                                          for op in coll))
        return graph


def _local_bytes(tree) -> int:
    """Bytes of the local blocks of a tree's tensors (DTensors by their
    local tensor), each tensor once."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor) or id(t) in seen:
            continue
        seen.add(id(t))
        local = t.to_local() if isinstance(t, DTensor) else t
        total += local.numel() * local.element_size()
    return total


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` default process group of ``n`` ranks (this process is
    rank 0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, *, cfg=None, mesh=None,
             recorder: Optional[_LocalRecorder] = None) -> Dict:
    """Run one cell on meta DTensors; returns the stats record.  ``mesh``
    defaults to the production mesh (then the default process group must
    be a ``fake`` one of its size: see :func:`fake_world`); ``cfg``
    defaults to the arch's published config; ``recorder`` to a fresh
    :class:`_LocalRecorder` (a subclass may file the ops further, as
    ``scripts/torch_memdebug.py``'s does).  The plain path runs
    (``use_kernels=False``)."""
    from torch.distributed.tensor.debug import CommDebugMode
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device="cpu")
    cfg = dataclasses.replace(cfg or get_config(arch), use_kernels=False)
    n_dev = mesh.size()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.shape),
           "n_devices": n_dev, "kind": shape.kind}
    t0 = time.time()
    rec_mode = recorder if recorder is not None else _LocalRecorder()
    with set_mesh(mesh):
        fn, specs = cell_fn_and_specs(arch, shape, mesh, cfg=cfg)
        t1 = time.time()
        with CommDebugMode() as comm, _on_chip_regions(rec_mode), rec_mode:
            out = fn(*specs)
        t2 = time.time()
    rec["specs_s"] = round(t1 - t0, 2)
    rec["run_s"] = round(t2 - t1, 2)
    params = specs[0]
    rec["n_params"] = int(sum(t.numel() for t in leaves(params)))
    arg = _local_bytes(specs)
    in_ids = {id(t) for t in leaves(specs)}
    outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
    alias = _local_bytes([t for t in outs if id(t) in in_ids])
    res = _local_bytes(outs)
    rec["memory"] = {"argument_size_in_bytes": arg,
                     "param_bytes_per_device": _local_bytes(params),
                     "output_size_in_bytes": res,
                     "alias_size_in_bytes": alias,
                     "total_bytes_per_device": arg + res - alias,
                     "not_measured": NOT_MEASURED}
    graph = rec_mode.graph()
    top_ops = dict(sorted(graph.bytes_by_opcode.items(),
                          key=lambda kv: -kv[1])[:10])
    rec["hlo"] = {
        "flops_per_device": graph.flops,
        "bytes_per_device": graph.bytes_accessed,
        "collectives": graph.collectives,
        "collective_wire_bytes": graph.collective_wire,
        "bytes_by_opcode": top_ops,
        "flash_block_bytes": graph.flash_block_bytes,
    }
    rec["comm_counts"] = {str(k): int(v)
                          for k, v in comm.get_comm_counts().items()}
    if verbose:
        mb = rec["memory"]["total_bytes_per_device"] / 2**30
        print(f"[dryrun] {arch:24s} {shape_name:12s} {rec['mesh']:8s} "
              f"run={rec['run_s']:7.1f}s mem/dev={mb:6.2f}GiB "
              f"flops/dev={graph.flops:.3e} "
              f"wire/dev={graph.collective_wire:.3e}", flush=True)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every runnable (arch x shape) cell")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        cells, skips = all_cells()
        todo = [(a, s) for a, s, _ in cells]
        for a, s, reason in skips:
            print(f"[dryrun] SKIP {a} {s}: {reason}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        reason = applicable(args.arch, args.shape)
        if reason:
            print(f"[dryrun] SKIP {args.arch} {args.shape}: {reason}")
            return 0
        todo = [(args.arch, args.shape)]

    failures = []
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch, shape in todo:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                path = out_dir / f"{tag}.json"
                try:
                    rec = run_cell(arch, shape, mp)
                    path.write_text(json.dumps(rec, indent=1))
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"[dryrun] FAIL {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for t, e in failures:
            print("  ", t, e)
        return 1
    print(f"[dryrun] all {len(todo) * len(meshes)} cells ran OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
