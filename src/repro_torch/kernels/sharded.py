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
* each operand's and output's DTensor placements come from
  ``assignment.spec(...)`` (:func:`~repro_torch.parallel.api.to_placements`),
  one placement list per tensor;
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
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import torch

from repro_torch.parallel.api import (PartitionSpec, current_mesh,
                                      is_dtensor, shard_assignment,
                                      to_placements)

__all__ = ["flash_attention", "decode_attention", "mamba2_ssd", "moe_gmm",
           "SHARDED_LAUNCHES", "assignment", "any_dtensor",
           "refuse_dtensors"]

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


def assignment(kernel: str, shapes: Mapping[str, int]):
    """(mesh, ShardAssignment) of a sharded call of ``kernel``; raises a
    ``ValueError`` without an active mesh or without a contract."""
    from repro_torch.kernels.plan import get_kernel
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            f"{kernel}: a DTensor operand requires an active mesh "
            "(repro_torch.parallel.set_mesh)")
    logical = get_kernel(kernel).logical
    if logical is None:
        raise _no_contract(kernel)
    return mesh, shard_assignment(shapes, logical, mesh)


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


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_len: Optional[int] = None):
    from repro_torch.kernels.flash_attention import flash_attention as one
    B, S, H, hd = q.shape
    mesh, asn = assignment(
        "flash_attention",
        {"B": B, "S": S, "T": k.shape[1], "H": H, "KV": k.shape[2],
         "hd": hd})
    qs, kvs = asn.spec("B", None, "H", None), asn.spec("B", None, "KV", None)
    return _run("flash_attention", mesh,
                lambda ql, kl, vl: one(ql, kl, vl, causal=causal,
                                       kv_len=kv_len),
                qs, (qs, kvs, kvs), q, k, v)


def decode_attention(q, k, v, kv_len):
    from repro_torch.kernels.decode_attention import decode_attention as one
    B, H, hd = q.shape
    mesh, asn = assignment(
        "decode_attention",
        {"B": B, "T": k.shape[1], "H": H, "KV": k.shape[2], "hd": hd})
    qs, kvs = asn.spec("B", "H", None), asn.spec("B", None, "KV", None)
    if isinstance(kv_len, torch.Tensor):
        return _run("decode_attention", mesh, one, qs,
                    (qs, kvs, kvs, asn.spec("B")), q, k, v, kv_len)
    return _run("decode_attention", mesh,
                lambda ql, kl, vl: one(ql, kl, vl, kv_len), qs,
                (qs, kvs, kvs), q, k, v)


def mamba2_ssd(x, dt, A, Bm, Cm):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd as one
    B, S, nh, hd = x.shape
    mesh, asn = assignment(
        "mamba2_ssd",
        {"B": B, "S": S, "nh": nh, "hd": hd, "ds": Bm.shape[3],
         "G": Bm.shape[2]})
    bc = asn.spec("B", None, "G", None)
    return _run("mamba2_ssd", mesh,
                one,
                (asn.spec("B", None, "nh", None),
                 asn.spec("B", "nh", None, None)),
                (asn.spec("B", None, "nh", None), asn.spec("B", None, "nh"),
                 asn.spec("nh"), bc, bc), x, dt, A, Bm, Cm)


def moe_gmm(x, w):
    from repro_torch.kernels.moe_gmm import moe_gmm as one
    E, C, K = x.shape
    mesh, asn = assignment("moe_gmm",
                           {"E": E, "C": C, "K": K, "N": w.shape[2]})
    es = asn.spec("E", None, None)
    return _run("moe_gmm", mesh, one, es, (es, es), x, w)
