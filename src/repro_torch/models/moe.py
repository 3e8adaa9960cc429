"""Mixture-of-Experts FFN: top-k router and capacity-based gather dispatch
(twin of ``repro.models.moe``).

Groups are batch rows.  Each group's S tokens pick their top-k experts;
each expert takes the first C = :func:`capacity` assignments that reach
it in token order and drops the rest (Switch semantics).  Integer slot
maps move the tokens with gathers:

  dispatch:  xbuf[g, e, c, :] = x[g, src[g, e, c], :]
  experts:   ybuf = swiglu(xbuf @ We_in) @ We_out
  combine:   y[g, t] = sum_k gate * ybuf[g, e(t, k), p(t, k), :]

Two paths for the three expert products, as in the reference:

* ``cfg.use_kernels`` (the reference's ``use_pallas``): the batch groups
  fold into each expert's rows and the product runs
  :func:`repro_torch.kernels.moe_gmm` (the CUDA kernel on the card, its
  plain version on the CPU), which rounds its output to x's dtype; the
  gate and up outputs are then taken to f32 for the SiLU product;
* otherwise :func:`repro_torch.models.layers.mm`, whose gate and up
  outputs stay in f32.

Under a mesh (:func:`repro_torch.parallel.set_mesh`) the reference's
layout annotations are kept at its sites (:func:`shard`: tokens on
``batch``, slot buffers on ``batch`` x ``expert``) and ``moe_gmm`` runs
through its sharded wrapper, one expert block a shard.  The slot maps
run one block of groups a rank under ``local_map``
(:func:`_slot_maps`), and the expert products fold the groups into each
expert's rows through a contiguous copy (:class:`_Relayout`); without a
mesh neither touches DTensor.

While :mod:`repro_torch.trace` records, each call leaves a
``moe.dispatch`` record (E, B, C) holding the slot occupancy mask it
computes anyway; read, it is the kept assignments per expert.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels import moe_gmm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, dense, mm
from repro_torch.parallel.api import (current_mesh, is_dtensor,
                                      named_sharding, shard)

__all__ = ["init_moe", "moe_apply", "router_topk", "capacity"]


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    c = int(math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                      / m.n_experts))
    return max(4, ((c + 3) // 4) * 4)  # pad to a multiple of 4


def init_moe(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> Dict:
    """Router (f32), the experts' gate/up/down weights with a leading E
    axis, and the shared experts when the config has them; the
    reference's initialisation scales."""
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.n_experts, m.d_ff_expert
    dt = cdtype(cfg)
    s = 1.0 / math.sqrt(D)

    def normal(shape, std, dtype=dt):
        return (torch.randn(shape, generator=gen, device=device)
                * std).to(dtype)

    w = {"router": normal((D, E), s, torch.float32),
         "we_g": normal((E, D, F_), s),
         "we_i": normal((E, D, F_), s),
         "we_o": normal((E, F_, D), 1.0 / math.sqrt(F_)
                        / math.sqrt(max(1, cfg.n_layers)))}
    if m.n_shared:
        Fs = m.d_ff_shared or m.n_shared * F_
        w["shared"] = {"wg": normal((D, Fs), s), "wi": normal((D, Fs), s),
                       "wo": normal((Fs, D), 1.0 / math.sqrt(Fs))}
    return w


def router_topk(cfg: ModelConfig, w_router: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: f32 softmax over experts, top-k, renormalised gates.

    x: (G, S, D) -> gates (G, S, K) f32, idx (G, S, K) int64, aux_loss
    scalar.  Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them (a stable descending sort; ``torch.topk`` promises no
    order)."""
    m = cfg.moe
    logits = torch.matmul(x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :m.top_k], order[..., :m.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss.
    me = probs.mean(dim=(0, 1))                                      # (E,)
    ce = F.one_hot(idx, m.n_experts).float().mean(dim=(0, 1, 2))     # (E,)
    aux = m.n_experts * torch.sum(me * ce)
    return gates, idx, aux


def _slot_maps(cfg: ModelConfig, idx: torch.Tensor, C: int):
    """Integer slot maps from expert assignments (see :func:`_group_maps`).

    A DTensor ``idx`` (under a mesh) is mapped one block of groups a rank
    under ``local_map``: the maps of a group read only its own row, so
    no rank needs another's, and the scatters write the rank's own
    tensors (DTensor's in-place scatter into a plain tensor fails).
    ``src`` and ``used`` are then laid out on ``batch`` x ``expert``, as
    in the reference."""
    if not is_dtensor(idx):
        return _group_maps(cfg, idx, C)
    from torch.distributed.tensor.experimental import local_map
    mesh = current_mesh()
    pl = named_sharding(idx.shape, ("batch", None), mesh)
    pos, keep, src, used = local_map(
        lambda i: _group_maps(cfg, i, C), out_placements=(pl,) * 4,
        in_placements=(pl,), device_mesh=mesh,
        redistribute_inputs=True)(idx)
    return pos, keep, shard(src, "batch", "expert"), \
        shard(used, "batch", "expert")


def _group_maps(cfg: ModelConfig, idx: torch.Tensor, C: int):
    """Integer slot maps from expert assignments, on plain tensors.

    idx: (G, A) expert ids (A = S*K assignments in token order).
    Returns:
      pos   (G, A)   position of each assignment within its expert
      keep  (G, A)   pos < C
      src   (G, E*C) assignment index feeding each expert slot (0 if empty)
      used  (G, E*C) slot occupancy mask

    Assignments past capacity scatter to a sink slot E*C, sliced off
    after (the reference's out-of-bounds scatter with ``mode="drop"``);
    kept slots are unique, so only the sink sees duplicate writes."""
    E = cfg.moe.n_experts
    G, A = idx.shape
    idx = idx.long()
    pos_all = torch.cumsum(F.one_hot(idx, E), dim=1) - 1            # (G,A,E)
    pos = torch.gather(pos_all, 2, idx[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, idx * C + pos, E * C)
    arange = torch.arange(A, device=idx.device).expand(G, A)
    src = torch.zeros((G, E * C + 1), dtype=torch.long, device=idx.device)
    src.scatter_(1, slot, arange)
    used = torch.zeros((G, E * C + 1), dtype=torch.bool, device=idx.device)
    used.scatter_(1, slot, True)
    return pos, keep, src[:, :E * C], used[:, :E * C]


def _expert_mm(x4: torch.Tensor, w3: torch.Tensor, *, use_kernels: bool,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-expert batched matmul (B, E, C, K) @ (E, K, N) -> (B, E, C, N),
    accumulated in f32; the result is f32, or ``out_dtype`` when given.

    The batch groups fold into each expert's rows.  With ``use_kernels``
    :func:`moe_gmm` runs, whose output is in x's dtype (one rounding
    more than ``mm``'s f32 output: the reference's Pallas path takes it
    too); otherwise ``mm`` runs (folding first, so that the weights are
    not broadcast over B)."""
    B = x4.shape[0]
    xe = _fold(x4)
    if use_kernels:
        y = moe_gmm(xe, w3)
        y = y.to(torch.float32 if out_dtype is None else out_dtype)
    else:
        y = mm(xe, w3, out_dtype=out_dtype)
    return _unfold(y, B)


def _fold(x4: torch.Tensor) -> torch.Tensor:
    """(B, E, C, K) -> (E, B * C, K)."""
    if is_dtensor(x4):
        return _Relayout.apply(x4, True, x4.shape[0])
    B, E, C, K = x4.shape
    return x4.transpose(0, 1).reshape(E, B * C, K)


def _unfold(y: torch.Tensor, B: int) -> torch.Tensor:
    """(E, B * C, N) -> (B, E, C, N)."""
    if is_dtensor(y):
        return _Relayout.apply(y, False, B)
    E, BC, N = y.shape
    return y.reshape(E, B, BC // B, N).transpose(0, 1)


class _Relayout(torch.autograd.Function):
    """:func:`_fold` (``fold``) or :func:`_unfold` of a DTensor, each the
    other's backward, through a contiguous copy: a redistribute can leave
    a DTensor's strides unlike its local block's, and a view of the block
    that the strides allow then fails."""

    @staticmethod
    def _apply(t, fold: bool, B: int):
        if fold:
            _, E, C, K = t.shape
            t = t.transpose(0, 1)
            shape = (E, B * C, K)
        else:
            E, BC, N = t.shape
            shape = (E, B, BC // B, N)
        t = t.clone(memory_format=torch.contiguous_format).reshape(shape)
        return t if fold else t.transpose(0, 1)

    @staticmethod
    def forward(ctx, t, fold: bool, B: int):
        ctx.fold, ctx.B = fold, B
        return _Relayout._apply(t, fold, B)

    @staticmethod
    def backward(ctx, g):
        return _Relayout._apply(g, not ctx.fold, ctx.B), None, None


def _kept_per_expert(used: torch.Tensor) -> torch.Tensor:
    """(B, E, C) slot occupancy -> (E,) kept assignments per expert."""
    return used.sum(dim=(0, 2))


def moe_apply(cfg: ModelConfig, w, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Groups = batch rows."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    C = capacity(cfg, S)
    x = shard(x, "batch", None, "tp")
    gates, idx, aux = router_topk(cfg, w["router"], x)

    idx_flat = idx.reshape(B, S * K)                   # assignment order: (t, k)
    pos, keep, src, used = _slot_maps(cfg, idx_flat, C)
    rec = trace.count("moe.dispatch")
    if rec:
        rec.attrs.update(E=E, B=B, C=C)
        rec.hold(used.view(B, E, C), _kept_per_expert)

    # token index of each assignment; gather tokens into expert slot buffers
    tok_of_src = src // K                                             # (B, E*C)
    xbuf = torch.gather(x, 1, tok_of_src[..., None].expand(-1, -1, D))
    xbuf = xbuf * used[..., None].to(x.dtype)
    xbuf = shard(xbuf.reshape(B, E, C, D), "batch", "expert", None, None)

    h = F.silu(_expert_mm(xbuf, w["we_g"], use_kernels=cfg.use_kernels)) \
        * _expert_mm(xbuf, w["we_i"], use_kernels=cfg.use_kernels)
    h = shard(h.to(x.dtype), "batch", "expert", None, None)
    ybuf = _expert_mm(h, w["we_o"], use_kernels=cfg.use_kernels,
                      out_dtype=x.dtype)

    # combine: gather each kept assignment's slot output, weight, sum over k
    slot = torch.where(keep, idx_flat.long() * C + pos, 0)            # (B,S*K)
    y_k = torch.gather(ybuf.reshape(B, E * C, D), 1,
                       slot[..., None].expand(-1, -1, D))             # (B,S*K,D)
    gk = (gates.reshape(B, S * K) * keep.float()).to(x.dtype)
    y_k = shard(y_k, "batch", None, "tp")
    y = (y_k * gk[..., None]).reshape(B, S, K, D).sum(dim=2)

    if m.n_shared:
        ws = w["shared"]
        hs = F.silu(dense(x, ws["wg"])) * dense(x, ws["wi"])
        y = y + dense(hs, ws["wo"])
    return shard(y, "batch", "seq", None), aux * m.router_aux_weight
