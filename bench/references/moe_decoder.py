"""Plain reference of a GQA decoder with a top-k mixture-of-experts FFN
(Qwen3-MoE).

The attention, norms, RoPE and unembedding are
:mod:`dense_decoder`'s; the FFN is the published router and experts:
``p = softmax(x R)`` in float32, the ``num_experts_per_tok`` largest
(ties to the lower index), their gates renormalised to sum to one, and
``y = sum_k gate_k * expert_k(x)``, each expert a SwiGLU of width
``moe_intermediate_size``.

One departure from the published model, stated in the config file
(``capacity_factor``): within a group of S rows each expert takes at
most ``C = max(4, 4 * ceil(ceil(S * top_k * capacity_factor / E) / 4))``
assignments, the first in (row, k) order, and a dropped assignment adds
nothing (the others keep their gates).  A group is one prefill chunk of
the serving engine, sized ``prefill_chunk`` (its padding rows come after
its tokens, so they take no token's place), or one decode row, which
never drops.  The caller says which rows form a group.
"""

from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path
from typing import List, Optional

import torch
import torch.nn.functional as F


def _sibling(name: str):
    key = f"h100bench_references_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, Path(__file__).with_name(f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


dense = _sibling("dense_decoder")
Group = dense.Group


def capacity(c: dict, size: int) -> int:
    E, K = c["num_experts"], c["num_experts_per_tok"]
    cap = math.ceil(size * K * c["capacity_factor"] / E)
    return max(4, ((cap + 3) // 4) * 4)


def route(c: dict, w: dict, x: torch.Tensor):
    """x (n, D) -> gates (n, K) float32, experts (n, K)."""
    probs = torch.softmax(x @ w["router"].float(), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = c["num_experts_per_tok"]
    gates = vals[:, :K]
    return gates / gates.sum(-1, keepdim=True), order[:, :K]


def keep_mask(c: dict, idx: torch.Tensor, groups) -> torch.Tensor:
    """(n, K) True where an assignment is within its expert's capacity:
    rows outside every group are groups of one (never dropped)."""
    E = c["num_experts"]
    keep = torch.ones_like(idx, dtype=torch.bool)
    for start, end, size in groups:
        a = idx[start:end].reshape(-1)
        rows = torch.arange(a.numel(), device=a.device)
        pos = torch.cumsum(F.one_hot(a, E), dim=0)[rows, a] - 1
        keep[start:end] = (pos < capacity(c, size)).view(end - start, -1)
    return keep


def moe_ffn(c: dict, w: dict, x: torch.Tensor, groups: List[Group],
            quant: Optional[str]) -> torch.Tensor:
    """x (n, D) -> (n, D); ``groups`` in x's row numbers."""
    gates, idx = route(c, w, x)
    gates = gates * keep_mask(c, idx, groups)
    y = torch.zeros_like(x)
    for e in range(c["num_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(dense.linear(xe, w["we_g"][e], None, quant)) \
            * dense.linear(xe, w["we_i"][e], None, quant)
        ye = dense.linear(h, w["we_o"][e], None, quant)
        y.index_add_(0, rows, ye * gates[rows, slot][:, None])
    return y


def logits(c: dict, weights: dict, seqs, score_from, groups,
           quant: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`dense_decoder.forward` with the MoE FFN."""
    return dense.forward(c, weights, seqs, score_from, groups, moe_ffn,
                         quant)
