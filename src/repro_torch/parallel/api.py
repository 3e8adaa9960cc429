"""Mesh/axis plumbing shared by the model and the launchers (twin of
``repro.parallel.api``) on ``torch.distributed``'s ``DeviceMesh`` and
DTensor.

* Physical mesh axes: ``pod`` (the slow axis, multi-pod only), ``data``
  (batch + FSDP), ``model`` (TP + EP): the names of the mesh's dims.
* Model code never names physical axes.  It annotates tensors with
  *logical* axes (``"batch"``, ``"embed"``, ``"heads"``, ...) through
  :func:`shard`; :class:`AxisSpec` maps logical -> physical with a
  divisibility guard, so e.g. a 51865-row vocab drops the 16-way
  ``model`` axis instead of failing to partition.  The rules, the guard,
  "first wins" and the grouped-divisibility rule of
  :func:`shard_assignment` are the reference's, copied as they are.
* ``set_mesh`` (a context manager) installs the mesh and the rules,
  thread-locally; ``current_mesh``/``current_axes`` read them.  Outside a
  mesh every annotation is a no-op, so the same model code runs
  unsharded in the tests and on a mesh in the dry-run.  Inside a mesh
  ``set_mesh`` also enters DTensor's ``implicit_replication``: a plain
  tensor the model makes next to a DTensor (positions, masks, RoPE
  frequencies, index vectors) counts as replicated on the mesh, and the
  sharding rules the model needs beyond DTensor's own are registered
  (:func:`register_rules`).

:func:`logical_to_spec` returns the port's :class:`PartitionSpec`, a
tuple with one entry per tensor dim (None, an axis name, or a tuple of
names), equal entry for entry to the reference's ``PartitionSpec``.
:func:`to_placements` turns it into DTensor placements, one per mesh dim:
``Shard(d)`` on every mesh dim that a tensor dim ``d`` names, else
``Replicate()``.

**Rank layout of a multi-axis dim (a deliberate difference).**  A dim
that takes two mesh axes, e.g. ``kv_seq -> ("model", "data")``, is
model-major in JAX: the row block a device holds is indexed by its
``model`` coordinate first.  DTensor shards a dim over its mesh dims in
mesh-dim order (``data`` before ``model`` on a ``("data", "model")``
mesh).  Each device holds a block of the same shape, but not the same
rows.  The two packages are held to each other by local shapes and by
global values, never by which rows a rank holds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_map_with_path

__all__ = ["AxisSpec", "DEFAULT_RULES", "PartitionSpec", "set_mesh",
           "current_mesh", "current_axes", "shard", "logical_to_spec",
           "named_sharding", "to_placements", "mesh_sizes", "place",
           "place_tree", "assign", "write_rows", "is_dtensor", "register_rules",
           "ShardAssignment", "shard_assignment", "local_shapes"]


Physical = Tuple[str, ...]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh-axis name, or a
    tuple of names (the dim split over several axes, major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """Logical-axis -> physical-mesh-axes mapping ("the rules")."""

    rules: Tuple[Tuple[str, Physical], ...]

    def physical(self, logical: Optional[str]) -> Physical:
        if logical is None:
            return ()
        for name, phys in self.rules:
            if name == logical:
                return phys
        return ()

    def replace(self, **updates: Physical) -> "AxisSpec":
        d = dict(self.rules)
        d.update(updates)
        return AxisSpec(tuple(d.items()))


#: Baseline rules (the reference's).  ``batch`` spans the pure-DP pod
#: axis plus the data axis; ``fsdp`` (weight sharding) stays on the fast
#: ``data`` axis, then the pod axis; tensor/expert parallelism on
#: ``model``; context parallelism reuses ``data``; the decode cache's
#: sequence takes ``model`` first, then ``data`` when it is free.
DEFAULT_RULES = AxisSpec((
    ("batch", ("pod", "data")),
    ("fsdp", ("data", "pod")),
    ("tp", ("model",)),
    ("expert", ("model",)),
    ("context", ("data",)),
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("seq", ("model",)),
    ("seq_tp", ("model",)),
    ("kv_seq", ("model", "data")),
))


class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.axes: AxisSpec = DEFAULT_RULES


_STATE = _State()


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its dim names), or of any
    object whose ``shape`` is already such a mapping."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names (e.g. "
                         "init_device_mesh(..., mesh_dim_names=('data', "
                         "'model')))")
    return dict(zip(names, tuple(shape)))


_RULES: List = []


def register_rules() -> None:
    """Give DTensor the sharding rules it lacks for the model's ops
    (once a process): ``aten.mm.dtype``, the bf16 product with an f32
    output (``models.layers.mm`` on the card), takes ``aten.mm``'s rule
    (rows, columns, a contraction leaving a partial sum, or replicated).
    """
    if _RULES:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.mm.dtype)
    def _mm_dtype(a, b, out_dtype):
        r, p = Replicate(), Partial()
        return [([r], [r, r, None]), ([Shard(0)], [Shard(0), r, None]),
                ([Shard(1)], [r, Shard(1), None]),
                ([p], [Shard(1), Shard(0), None]), ([p], [p, r, None]),
                ([p], [r, p, None])]

    _RULES.append(_mm_dtype)


@contextlib.contextmanager
def set_mesh(mesh, axes: AxisSpec = DEFAULT_RULES):
    """Install ``mesh`` (a ``DeviceMesh`` with named dims, or None) and
    ``axes`` for the calling thread; under a mesh, plain tensors mixed
    with DTensors count as replicated (DTensor's
    ``implicit_replication``)."""
    prev = (_STATE.mesh, _STATE.axes)
    _STATE.mesh, _STATE.axes = mesh, axes
    try:
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            register_rules()
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _STATE.mesh, _STATE.axes = prev


def current_mesh():
    return _STATE.mesh


def current_axes() -> AxisSpec:
    return _STATE.axes


def _filter_axes(sizes: Mapping[str, int], dim: int,
                 phys: Physical) -> Physical:
    """Keep only mesh axes that exist and evenly divide ``dim``."""
    out = []
    size = 1
    for ax in phys:
        if ax not in sizes:
            continue
        nsz = size * sizes[ax]
        if dim % nsz != 0:
            continue
        size = nsz
        out.append(ax)
    return tuple(out)


def logical_to_spec(shape: Sequence[int],
                    logical: Sequence[Optional[str]],
                    mesh=None,
                    axes: Optional[AxisSpec] = None) -> PartitionSpec:
    """Build a :class:`PartitionSpec` for ``shape`` from logical axis
    names.

    Divisibility-guarded: axes that do not divide the dim (or are absent
    from the mesh) are dropped, and an axis may be used by only one dim
    (first wins), as GSPMD requires."""
    if len(shape) != len(logical):
        raise ValueError(
            "logical_to_spec: shape and logical axis names must have the "
            f"same rank; got shape={tuple(shape)} (rank {len(shape)}) vs "
            f"logical={tuple(logical)} (rank {len(logical)})")
    mesh = mesh or current_mesh()
    axes = axes or current_axes()
    if mesh is None:
        return P(*([None] * len(shape)))
    sizes = mesh_sizes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        phys = [a for a in axes.physical(name) if a not in used]
        phys = _filter_axes(sizes, dim, tuple(phys))
        used.update(phys)
        if not phys:
            parts.append(None)
        elif len(phys) == 1:
            parts.append(phys[0])
        else:
            parts.append(tuple(phys))
    return P(*parts)


def to_placements(spec: Sequence, mesh) -> List:
    """DTensor placements (one per mesh dim) of a :class:`PartitionSpec`:
    ``Shard(d)`` on each mesh dim of size > 1 that tensor dim ``d`` names,
    else ``Replicate()`` (a size-1 axis holds one block either way, and
    DTensor will not view a dim sharded even one way).  A dim named by
    several mesh dims is split over them in mesh-dim order (see the
    module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        for ax in (part,) if isinstance(part, str) else part:
            if sizes[ax] > 1:
                out[names.index(ax)] = Shard(d)
    return out


def named_sharding(shape: Sequence[int], logical: Sequence[Optional[str]],
                   mesh=None) -> Optional[List]:
    """The DTensor placements of ``shape`` under ``logical`` on ``mesh``
    (default the active one); None without a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return to_placements(logical_to_spec(shape, logical, mesh), mesh)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  None exists before DTensor's module is
    loaded, so the check costs a dict lookup and loads nothing: an
    unsharded run never pays for DTensor."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by logical axes: ``x.redistribute(...)`` when ``x``
    is a DTensor under an active mesh, the identity otherwise.  As jax's
    ``with_sharding_constraint`` does, it also lays out the gradient that
    flows back through it (DTensor's redistribute gives the gradient its
    input's placements), even where ``x`` already has the layout."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          named_sharding(x.shape, logical, mesh))


def place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A full tensor ``t`` that every rank holds, as a DTensor on
    ``mesh``: each rank keeps its own block, with no communication (on a
    one-rank mesh the tensor itself, without a copy)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, list(placements), run_check=False)
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def place_tree(tree, rule, mesh):
    """Every leaf of ``tree`` (full tensors, the same on every rank) as a
    DTensor on ``mesh``, laid out by ``rule(path, leaf)``'s logical axes
    (e.g. ``models.model.param_axes_rule``)."""
    return tree_map_with_path(
        lambda path, t: place(t, mesh, named_sharding(t.shape,
                                                      rule(path, t), mesh)),
        tree)


def _row_offset(x, dim: int) -> Tuple[int, int]:
    """(global offset, local length) of this rank's block of DTensor
    ``x`` along ``dim`` (even blocks, split in mesh-dim order)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    idx, parts = 0, 1
    for m, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx = idx * mesh.size(m) + coord[m]
            parts *= mesh.size(m)
    n = x.shape[dim] // parts
    return idx * n, n


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` in place.  For a DTensor ``dst``, ``src`` is laid
    out like ``dst`` first and each rank writes its own block, so the
    storage ``dst`` holds is the one written."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def write_rows(dst: torch.Tensor, dim: int, start: int,
               src: torch.Tensor) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` in place (n =
    ``src.shape[dim]``): the decode steps' cache writes.  For a DTensor
    ``dst`` sharded along ``dim``, ``src`` is replicated along ``dim`` and
    laid out like ``dst`` elsewhere, and each rank writes the rows that
    fall in its own block (DTensor's slice of a sharded dim would write
    a redistributed copy, not ``dst``)."""
    if not is_dtensor(dst):
        dst.narrow(dim, start, src.shape[dim]).copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
            for pl in dst.placements]
    src = src.redistribute(dst.device_mesh, want).to_local()
    off, n = _row_offset(dst, dim)
    lo, hi = max(start, off), min(start + src.shape[dim], off + n)
    if lo < hi:
        dst.to_local().narrow(dim, lo - off, hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


# ---------------------------------------------------------------------------
# Per-shard shape resolution (the local_map side of the kernel path).
#
# ``logical_to_spec`` answers "how is *one tensor* laid out"; the helpers
# below answer the op-level question the kernel layer needs: given the
# named dims of a whole op (B, H, KV, ...) and which logical axis each dim
# belongs to, how many ways does each dim shard on the active mesh, and
# what does one shard's shape look like?  Dims that share a logical axis
# (Q heads and KV heads both on "heads") shard *together*: a mesh axis is
# used only if every size>1 dim in the group divides by it, so the grouped
# ratios (H/KV for GQA, nh/G for SSD) survive partitioning.  Size-1 dims
# in a group are broadcast: they never block the axis and stay size 1 per
# shard (MQA's single KV head, Mamba-2's single B/C group).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """How an op's named dims land on the mesh.

    ``counts`` maps every dim name to its shard count (1 = replicated);
    ``axes_of`` maps the sharded dims to the physical mesh axes they use.
    """

    counts: Mapping[str, int]
    axes_of: Mapping[str, Physical]

    def spec(self, *dims: Optional[str]) -> PartitionSpec:
        """PartitionSpec for one tensor whose axes are the named dims.

        ``None`` marks a tensor axis that is not an op dim (always
        replicated).  The sharded kernel wrappers derive their local_map
        placements from it (:func:`to_placements`)."""
        parts = []
        for d in dims:
            phys = self.axes_of.get(d, ()) if d is not None else ()
            if not phys:
                parts.append(None)
            elif len(phys) == 1:
                parts.append(phys[0])
            else:
                parts.append(tuple(phys))
        return P(*parts)

    def local(self, shapes: Mapping[str, int]) -> Dict[str, int]:
        """Per-shard sizes of ``shapes`` under this assignment."""
        return {d: n // self.counts.get(d, 1) for d, n in shapes.items()}


def shard_assignment(shapes: Mapping[str, int],
                     logical: Mapping[str, Optional[str]],
                     mesh=None,
                     axes: Optional[AxisSpec] = None) -> ShardAssignment:
    """Assign mesh axes to an op's named dims via logical-axis rules.

    ``shapes`` maps dim name -> global size; ``logical`` maps dim name ->
    logical axis (dims absent from ``logical`` stay replicated).  Walks
    logical axes in first-appearance order of ``shapes``; each mesh axis
    is consumed by at most one logical axis (first wins, as in
    ``logical_to_spec``).  Without an active mesh everything is
    replicated."""
    unknown = [d for d in logical if d not in shapes]
    if unknown:
        raise ValueError(
            f"shard_assignment: logical map names dims {unknown} that are "
            f"not in shapes {sorted(shapes)}")
    mesh = mesh or current_mesh()
    axes = axes or current_axes()
    counts: Dict[str, int] = {d: 1 for d in shapes}
    axes_of: Dict[str, Physical] = {}
    if mesh is None:
        return ShardAssignment(counts, axes_of)
    sizes = mesh_sizes(mesh)
    used: set = set()
    seen: set = set()
    for dim in shapes:
        name = logical.get(dim)
        if name is None or name in seen:
            continue
        seen.add(name)
        group = [d for d in shapes if logical.get(d) == name]
        big = [d for d in group if shapes[d] > 1]
        if not big:
            continue
        assigned = []
        factor = 1
        for ax in axes.physical(name):
            if ax in used or ax not in sizes:
                continue
            nf = factor * sizes[ax]
            if any(shapes[d] % nf != 0 for d in big):
                continue
            factor = nf
            assigned.append(ax)
        if factor == 1:
            continue
        used.update(assigned)
        for d in big:
            counts[d] = factor
            axes_of[d] = tuple(assigned)
    return ShardAssignment(counts, axes_of)


def local_shapes(shapes: Mapping[str, int],
                 logical: Mapping[str, Optional[str]],
                 mesh=None,
                 axes: Optional[AxisSpec] = None) -> Dict[str, int]:
    """Map an op's global dim sizes to one shard's sizes on the mesh: the
    block a sharded kernel sees."""
    return shard_assignment(shapes, logical, mesh, axes).local(shapes)
