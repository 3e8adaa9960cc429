"""The sharded kernel path: each kernel runs on one shard of a mesh (twin
of the reference's ``sharded=True`` in ``repro.kernels.ops``, its
``_mesh_assignment`` and ``shard_map`` bodies; the port decides by its
operands, not by a flag).

The four kernels whose catalog entry (:mod:`repro_torch.kernels.plan`)
carries a ``logical`` contract run here: ``flash_attention``,
``decode_attention``, ``mamba2_ssd`` and ``moe_gmm``.  Each wrapper
sends its call here when an operand is a DTensor (:func:`any_dtensor`):
under a mesh the model hands its kernel sites DTensors, while a shard
body gets plain local tensors.  On the active mesh
(:func:`repro_torch.parallel.set_mesh`):

* the op's named dims get their mesh axes from
  :func:`~repro_torch.parallel.api.shard_assignment` on the catalog's
  contract (grouped divisibility: H and KV shard together, nh and G);
* each operand's and output's spec comes from the assignment
  (:func:`operand_specs`), and its DTensor placements from the spec
  (:func:`~repro_torch.parallel.api.to_placements`);
* ``torch.distributed.tensor.experimental.local_map`` redistributes the
  operands to those placements and calls the unsharded wrapper on each
  rank's block: on a CUDA tensor the CUDA kernel, on a CPU tensor its
  plain version.  The kernel only ever sees one shard.

A plain operand beside a DTensor one is first made a replicated
DTensor on the mesh (``DTensor.from_local`` with ``Replicate()``), so
what comes back is always a DTensor.  ``paged_decode_attention`` and
``mfma_gemm`` have no contract: a DTensor operand makes them raise a
``ValueError`` naming it (:func:`refuse_dtensors`), where the
reference's dispatch falls back to its plain path.  A DTensor operand
without an active mesh raises too.

``SHARDED_LAUNCHES`` counts the shard bodies that ran (one a rank a
call), so a run can show that its kernels went through this path; the
kernels' own ``LAUNCHES`` count the launches inside them as before.

:func:`on_local_blocks` runs a kernel on each block a larger mesh's
ranks would get, one after another on one device: on a one-rank mesh
every block is the whole tensor, so only this shows a kernel at a
shard's shapes without a process group of many devices.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import torch

from repro_torch.parallel.api import (PartitionSpec, current_mesh,
                                      is_dtensor, shard_assignment,
                                      to_placements)

__all__ = ["flash_attention", "decode_attention", "mamba2_ssd", "moe_gmm",
           "SHARDED_LAUNCHES", "operand_specs", "local_block",
           "on_local_blocks", "any_dtensor", "refuse_dtensors"]

SHARDED_LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                                    "decode_attention": 0, "mamba2_ssd": 0,
                                    "moe_gmm": 0}


def any_dtensor(*operands) -> bool:
    """Whether a wrapper's call runs sharded: an operand is a DTensor."""
    return any(map(is_dtensor, operands))


def _no_contract(kernel: str) -> ValueError:
    return ValueError(
        f"{kernel}: no logical-axis contract in the kernel catalog "
        "(repro_torch.kernels.plan); this kernel cannot run sharded on a "
        "mesh")


def refuse_dtensors(kernel: str, *operands) -> None:
    """Raise a ``ValueError`` when a DTensor reaches ``kernel``, which has
    no logical-axis contract."""
    if any_dtensor(*operands):
        raise _no_contract(kernel)


def _dtensor(t: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _run(kernel: str, mesh, body: Callable,
         out_specs: Union[PartitionSpec, Sequence[PartitionSpec]],
         in_specs: Sequence[PartitionSpec], *tensors: torch.Tensor):
    from torch.distributed.tensor.experimental import local_map

    def counted(*local):
        SHARDED_LAUNCHES[kernel] += 1
        return body(*(t.contiguous() for t in local))

    if isinstance(out_specs, PartitionSpec):
        out_pl = to_placements(out_specs, mesh)
    else:
        out_pl = tuple(to_placements(s, mesh) for s in out_specs)
    fn = local_map(counted, out_placements=out_pl,
                   in_placements=tuple(to_placements(s, mesh)
                                       for s in in_specs),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*(_dtensor(t, mesh) for t in tensors))


def _op_shapes(kernel: str, operands) -> Dict[str, int]:
    """The named dims of ``kernel``'s contract on ``operands``."""
    if kernel == "flash_attention":
        q, k = operands[:2]
        B, S, H, hd = q.shape
        return {"B": B, "S": S, "T": k.shape[1], "H": H, "KV": k.shape[2],
                "hd": hd}
    if kernel == "decode_attention":
        q, k = operands[:2]
        B, H, hd = q.shape
        return {"B": B, "T": k.shape[1], "H": H, "KV": k.shape[2], "hd": hd}
    if kernel == "mamba2_ssd":
        x, Bm = operands[0], operands[3]
        B, S, nh, hd = x.shape
        return {"B": B, "S": S, "nh": nh, "hd": hd, "ds": Bm.shape[3],
                "G": Bm.shape[2]}
    x, w = operands[:2]
    E, C, K = x.shape
    return {"E": E, "C": C, "K": K, "N": w.shape[2]}


def operand_specs(kernel: str, *operands, mesh=None):
    """(the operands' specs, the output's spec or specs) of a sharded call
    of ``kernel`` on ``operands`` (the wrapper's positional operands; a
    per-request ``kv_len`` tensor counts as one) on ``mesh``, default
    the active one: the placements under which each rank's shard body
    gets its local blocks.  ``mesh`` may be any object whose ``shape``
    maps axis names to sizes (``parallel.api.mesh_sizes``)."""
    from repro_torch.kernels.plan import get_kernel
    logical = get_kernel(kernel).logical
    if logical is None:
        raise _no_contract(kernel)
    asn = shard_assignment(_op_shapes(kernel, operands), logical,
                           mesh if mesh is not None else current_mesh())
    if kernel == "flash_attention":
        qs, kvs = asn.spec("B", None, "H", None), \
            asn.spec("B", None, "KV", None)
        return (qs, kvs, kvs), qs
    if kernel == "decode_attention":
        qs, kvs = asn.spec("B", "H", None), asn.spec("B", None, "KV", None)
        return (qs, kvs, kvs, asn.spec("B"))[:len(operands)], qs
    if kernel == "mamba2_ssd":
        bc = asn.spec("B", None, "G", None)
        return ((asn.spec("B", None, "nh", None), asn.spec("B", None, "nh"),
                 asn.spec("nh"), bc, bc),
                (asn.spec("B", None, "nh", None),
                 asn.spec("B", "nh", None, None)))
    es = asn.spec("E", None, None)
    return (es, es), es


def local_block(t: torch.Tensor, spec: Sequence, coord: Sequence[int],
                sizes: Mapping[str, int]) -> tuple:
    """The index of the block of ``t`` (laid out by ``spec``) that the
    rank at ``coord`` (one index a mesh dim) of a mesh of ``sizes`` (axis
    name -> size, in mesh-dim order) holds: each dim split evenly over
    its mesh axes in mesh-dim order, as DTensor's ``Shard`` splits it."""
    names, index = list(sizes), []
    for d, part in enumerate(spec):
        axes = () if part is None else (part,) if isinstance(part, str) \
            else part
        i, parts = 0, 1
        for m, name in enumerate(names):
            if name in axes:
                i, parts = i * sizes[name] + coord[m], parts * sizes[name]
        n = t.shape[d] // parts
        index.append(slice(i * n, (i + 1) * n))
    return tuple(index)


def on_local_blocks(kernel: str, fn: Callable, operands: Sequence,
                    sizes: Mapping[str, int], like):
    """``fn`` (``kernel``'s wrapper) run in this process on each local
    block of ``operands`` that the ranks of a mesh of ``sizes`` get from
    the sharded path (:func:`operand_specs`), one rank after another and
    with no process group: a kernel at a shard's shapes on one device.
    Returns (the outputs put back together, shaped as ``like``, a tensor
    or a tuple of them; the set of local operand shapes)."""
    import itertools
    from types import SimpleNamespace
    in_specs, out_specs = operand_specs(kernel, *operands,
                                        mesh=SimpleNamespace(shape=sizes))
    single = not isinstance(like, tuple)
    like, out_specs = ((like,), (out_specs,)) if single else (like,
                                                              out_specs)
    outs = [torch.full_like(t, float("nan")) for t in like]
    local = set()
    for coord in itertools.product(*(range(n) for n in sizes.values())):
        blocks = [t[local_block(t, sp, coord, sizes)].contiguous()
                  for t, sp in zip(operands, in_specs)]
        local.add(tuple(tuple(b.shape) for b in blocks))
        got = fn(*blocks)
        for o, g, sp in zip(outs, (got,) if single else got, out_specs):
            o[local_block(o, sp, coord, sizes)] = g
    return (outs[0] if single else tuple(outs)), local


def _sharded(kernel: str, body: Callable, *operands):
    """``body`` on each rank's blocks of ``operands`` under ``local_map``,
    placed by :func:`operand_specs`."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            f"{kernel}: a DTensor operand requires an active mesh "
            "(repro_torch.parallel.set_mesh)")
    in_specs, out_specs = operand_specs(kernel, *operands, mesh=mesh)
    return _run(kernel, mesh, body, out_specs, in_specs, *operands)


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_len: Optional[int] = None):
    from repro_torch.kernels.flash_attention import flash_attention as one
    return _sharded("flash_attention",
                    lambda ql, kl, vl: one(ql, kl, vl, causal=causal,
                                           kv_len=kv_len), q, k, v)


def decode_attention(q, k, v, kv_len):
    from repro_torch.kernels.decode_attention import decode_attention as one
    if isinstance(kv_len, torch.Tensor):
        return _sharded("decode_attention", one, q, k, v, kv_len)
    return _sharded("decode_attention",
                    lambda ql, kl, vl: one(ql, kl, vl, kv_len), q, k, v)


def mamba2_ssd(x, dt, A, Bm, Cm):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd as one
    return _sharded("mamba2_ssd", one, x, dt, A, Bm, Cm)


def moe_gmm(x, w):
    from repro_torch.kernels.moe_gmm import moe_gmm as one
    return _sharded("moe_gmm", one, x, w)
