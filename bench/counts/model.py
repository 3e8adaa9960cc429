"""Operations and bytes of the model's serving steps, from the config.

Counted as the algorithm needs them, whatever the program does besides:
each weight read once a step, each input row read and each output row
written once; a matrix product of (m, k) by (k, n) is 2 m k n
operations; attention of one query row over ``n`` keys is 4 heads
head_dim n (scores and the weighted sum).  Only rows that serve a
request count as useful: a prefill chunk's valid rows that are not
taken from the prefix cache, a decode step's ACTIVE rows.  ``d`` is
:func:`h100bench.weights.dims` of the config file.
"""

from __future__ import annotations

from typing import Optional, Sequence

ELEM = 2                    # bytes of a bf16 weight or activation


def attn_params(d: dict) -> int:
    D, H, KV, hd = d["D"], d["H"], d["KV"], d["hd"]
    return 2 * D * H * hd + 2 * D * KV * hd


def ffn_params_per_token(d: dict) -> int:
    """The FFN weights one token multiplies: its top-k experts and the
    router, or the dense SwiGLU."""
    if d["moe"]:
        return d["K"] * 3 * d["D"] * d["Fe"] + d["D"] * d["E"]
    return 3 * d["D"] * d["F"]


def row_flops(d: dict, keys: int) -> float:
    """One token through every layer, attending ``keys`` cached rows
    (itself included); no unembedding."""
    per_layer = 2 * (attn_params(d) + ffn_params_per_token(d)) \
        + 4 * d["H"] * d["hd"] * keys
    return float(d["L"] * per_layer)


def unembed_flops(d: dict) -> float:
    return 2.0 * d["D"] * d["V"]


def prefill_flops(d: dict, pos: int, nv: int) -> float:
    """A chunk of ``nv`` valid rows at positions ``pos .. pos + nv - 1``
    (row i attends i + 1 keys); its padding rows are not counted, nor
    the unembedding of its last row."""
    keys = nv * pos + nv * (nv + 1) // 2
    return nv * row_flops(d, 0) + 4.0 * d["L"] * d["H"] * d["hd"] * keys


def decode_flops(d: dict, lens: Sequence[int]) -> float:
    """A decode step's ACTIVE rows, each at cache length ``len`` (it
    attends ``len + 1`` keys) and unembedded."""
    return float(sum(row_flops(d, n + 1) + unembed_flops(d) for n in lens))


def weight_bytes(d: dict, experts_hit: Optional[Sequence[int]] = None
                 ) -> float:
    """Every weight a step reads once: all layers' attention and FFN
    (for MoE the router in f32 and the experts ``experts_hit[layer]``
    that took a row; all of them when None), norms, the unembedding."""
    D = d["D"]
    per_layer = attn_params(d) * ELEM + 2 * D * ELEM
    if d["bias"]:
        per_layer += (d["H"] + 2 * d["KV"]) * d["hd"] * ELEM
    total = d["L"] * per_layer + D * d["V"] * ELEM + D * ELEM
    if d["moe"]:
        expert = 3 * D * d["Fe"] * ELEM
        hits = experts_hit if experts_hit is not None else [d["E"]] * d["L"]
        total += d["L"] * D * d["E"] * 4 + sum(hits) * expert
    else:
        total += d["L"] * 3 * D * d["F"] * ELEM
    return float(total)


def kv_row_bytes(d: dict) -> int:
    """One cached row, K and V, of every layer."""
    return 2 * d["L"] * d["KV"] * d["hd"] * ELEM


def decode_bytes(d: dict, lens: Sequence[int],
                 experts_hit: Optional[Sequence[int]] = None) -> float:
    """A decode step over ``lens`` (its ACTIVE rows' cache lengths):
    the weights once, each live cached row read, each new row written,
    the token embeddings read and the f32 logits written."""
    rows = sum(n + 1 for n in lens)
    return (weight_bytes(d, experts_hit) + kv_row_bytes(d) * rows
            + len(lens) * (d["D"] * ELEM + d["V"] * 4))
