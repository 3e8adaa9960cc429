"""Plain reference of a GQA decoder with a dense SwiGLU FFN (Qwen2).

Plain PyTorch in float32 (TF32 off), no kernels, no cache, no batching:
each sequence runs causally over all its tokens, one layer at a time
for all sequences, with the layer's weights upcast as they are used.
It imports nothing of the program and reads only the config file and
the weights the benchmark made.

The block: ``h += attn(rms(h))``, ``h += ffn(rms(h))``, then a final
RMSNorm and the unembedding.  RMSNorm is ``x / sqrt(mean(x^2) + eps) *
w``; RoPE rotates the two halves of each head (``x1 cos - x2 sin``,
``x2 cos + x1 sin``) by ``position * theta^(-2i / head_dim)``; attention
is causal softmax(q k^T / sqrt(head_dim)) v, each KV head shared by
``heads / kv_heads`` query heads; the FFN is ``(silu(x Wg) * (x Wi))
Wo``.

``quant="fp8"`` computes every weight product in float8 (e4m3) instead:
the activation rounded per row and the weight per output column, each
scaled to the format's range, the products summed in float32.  That is
the benchmark's control, one precision below the configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

Group = Tuple[int, int, int]        # rows [start, end) and the group's size
_Q_BLOCK = 1024                     # query rows a block of attention
_FP8_MAX = 448.0                    # largest float8_e4m3fn value


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3, scaled per slice along
    ``dim`` so each slice's largest magnitude maps to the format's."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           quant: Optional[str] = None) -> torch.Tensor:
    """x (n, K) float32 @ w (K, N) upcast, plus ``b``."""
    wf = w.float()
    if quant == "fp8":
        x, wf = fp8(x, -1), fp8(wf, 0)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    y = x @ wf
    return y if b is None else y + b.float()


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1."""
    S, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).float().to(x.device)[:, None, :]
    sin = torch.sin(ang).float().to(x.device)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal GQA: q (S, H, hd), k/v (S, KV, hd) -> (S, H, hd)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (H, S, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, S, _Q_BLOCK):
        e = min(S, a + _Q_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:e], k[:, :e]) / math.sqrt(hd)
        mask = torch.arange(e, device=q.device)[None, :] \
            <= torch.arange(a, e, device=q.device)[:, None]
        s = torch.where(mask[None], s, float("-inf"))
        out[a:e] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1),
                                v[:, :e])
    return out


def attn_block(c: dict, w: dict, x: torch.Tensor,
               quant: Optional[str]) -> torch.Tensor:
    """One sequence's attention: x (S, D) normed -> (S, D)."""
    D, H, KV = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    hd = c.get("head_dim") or D // H
    S = x.shape[0]
    q = linear(x, w["wq"], w.get("bq"), quant).view(S, H, hd)
    k = linear(x, w["wk"], w.get("bk"), quant).view(S, KV, hd)
    v = linear(x, w["wv"], w.get("bv"), quant).view(S, KV, hd)
    theta = c["rope_theta"]
    o = attention(rope(q, theta), rope(k, theta), v)
    return linear(o.reshape(S, H * hd), w["wo"], None, quant)


def dense_ffn(c: dict, w: dict, x: torch.Tensor, groups: List[Group],
              quant: Optional[str]) -> torch.Tensor:
    """SwiGLU over all rows: x (n, D) -> (n, D)."""
    g = linear(x, w["wg"], None, quant)
    u = linear(x, w["wi"], None, quant)
    return linear(torch.nn.functional.silu(g) * u, w["wo"], None, quant)


Ffn = Callable[[dict, dict, torch.Tensor, List[Group], Optional[str]],
               torch.Tensor]


def forward(c: dict, weights: dict, seqs: Sequence[torch.Tensor],
            score_from: Sequence[int], groups: Sequence[List[Group]],
            ffn: Ffn, quant: Optional[str] = None) -> List[torch.Tensor]:
    """Float32 logits of each sequence at rows ``score_from[i]`` on.

    ``seqs`` are 1-D token tensors on the weights' device; ``groups[i]``
    lists sequence i's FFN groups in its own row numbers (read by an MoE
    FFN).  The layers run one at a time over every sequence; the FFN
    sees all sequences' rows at once, in order, with the groups moved to
    those rows' numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = c["rms_norm_eps"]
    flat, o = [], 0
    for t, gs in zip(seqs, groups):
        flat += [(o + a, o + e, size) for a, e, size in gs]
        o += t.shape[0]
    with torch.no_grad():
        hs = [weights["embed"][t.long()].float() for t in seqs]
        for w in weights["layers"]:
            hs = [h + attn_block(c, w["mixer"], rms(h, w["ln1"], eps), quant)
                  for h in hs]
            x = torch.cat([rms(h, w["ln2"], eps) for h in hs])
            y = ffn(c, w["ffn"], x, flat, quant)
            out, o = [], 0
            for h in hs:
                out.append(h + y[o:o + h.shape[0]])
                o += h.shape[0]
            hs = out
        return [linear(rms(h[s:], weights["final_norm"], eps),
                       weights["unembed"], None, quant)
                for h, s in zip(hs, score_from)]


def logits(c: dict, weights: dict, seqs, score_from, groups,
           quant: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`forward` with the dense FFN."""
    return forward(c, weights, seqs, score_from, groups, dense_ffn, quant)
