"""Decoder blocks and layer schedules, dense subset
(twin of ``repro.models.blocks``).

A layer signature ``(mixer, is_moe)`` classifies every layer, as in the
reference.  Every block is pre-norm with residuals:
``h += mixer(norm(h)); h += ffn(norm(h))``.  Only plain GQA attention
with a dense MLP is ported; other layer kinds raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, mlp_apply, norm_apply

__all__ = ["Sig", "layer_sigs", "schedule", "init_norm", "init_mlp",
           "init_layer", "apply_layer_paged", "apply_layer_prefill_paged"]

Sig = Tuple[str, bool]

_NOT_PORTED = {
    "ssm": "ROADMAP queue 1 item 9 (SSM and hybrid)",
    "cross": "ROADMAP queue 1 item 10 (MLA, cross-attention and encoder)",
    "attn_cross": "ROADMAP queue 1 item 10 (MLA, cross-attention and encoder)",
    "enc_attn": "ROADMAP queue 1 item 10 (MLA, cross-attention and encoder)",
    "mla": "ROADMAP queue 1 item 10 (MLA, cross-attention and encoder)",
    "moe": "ROADMAP queue 1 item 8 (MoE)",
}


def layer_sigs(cfg: ModelConfig) -> List[Sig]:
    sigs: List[Sig] = []
    for i in range(cfg.n_layers):
        if cfg.cross_attn and (i + 1) % cfg.cross_attn.period == 0:
            mixer = "cross"
        else:
            mixer = cfg.layer_kind(i)
        sigs.append((mixer, cfg.layer_is_moe(i)))
    return sigs


def schedule(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(first_k, period, n_periods): first_k unstacked layers, then
    n_periods repetitions of a `period`-layer cycle (the reference's
    layer layout, which :mod:`repro_torch.convert` unstacks)."""
    first_k = cfg.first_k_dense
    sigs = layer_sigs(cfg)[first_k:]
    n = len(sigs)
    for p in range(1, n + 1):
        if n % p == 0 and all(sigs[i] == sigs[i % p] for i in range(n)):
            return first_k, p, n // p
    return first_k, n, 1


def check_ported(cfg: ModelConfig, sig: Sig) -> None:
    """Raise ``NotImplementedError`` for a layer kind not ported yet."""
    mixer, is_moe = sig
    kind = "moe" if is_moe else ("mla" if cfg.mla and mixer == "attn"
                                 else mixer)
    if kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind!r} is not ported to repro_torch "
            f"yet: {_NOT_PORTED.get(kind, 'not on the ROADMAP')}")


def init_norm(cfg: ModelConfig, device: torch.device,
              d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm_type == "layer":
        return {"scale": torch.ones((d,), dtype=cdtype(cfg), device=device),
                "bias": torch.zeros((d,), dtype=cdtype(cfg), device=device)}
    return torch.ones((d,), dtype=cdtype(cfg), device=device)


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    dt = cdtype(cfg)
    s = 1.0 / math.sqrt(D)
    so = 1.0 / math.sqrt(F) / math.sqrt(max(1, cfg.n_layers))

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dt)

    if cfg.mlp_type == "gelu":
        return {"wi": normal((D, F), s),
                "bi": torch.zeros((F,), dtype=dt, device=device),
                "wo": normal((F, D), so),
                "bo": torch.zeros((D,), dtype=dt, device=device)}
    return {"wg": normal((D, F), s), "wi": normal((D, F), s),
            "wo": normal((F, D), so)}


def init_layer(cfg: ModelConfig, gen: torch.Generator, sig: Sig,
               device: torch.device) -> Dict:
    check_ported(cfg, sig)
    w: Dict = {"ln1": init_norm(cfg, device),
               "mixer": attn.init_attn(cfg, gen, device)}
    if cfg.d_ff > 0:
        w["ln2"] = init_norm(cfg, device)
        w["ffn"] = init_mlp(cfg, gen, device)
    return w


def _ffn(cfg: ModelConfig, w, h: torch.Tensor) -> torch.Tensor:
    if "ffn" not in w:
        return h
    return h + mlp_apply(cfg, w["ffn"], norm_apply(cfg, w["ln2"], h))


def apply_layer_paged(cfg: ModelConfig, sig: Sig, w, h: torch.Tensor,
                      cache: Dict, block_tables: torch.Tensor,
                      lens: torch.Tensor):
    """One layer of a continuous-batching decode tick against the shared
    block-paged pool, with per-request positions ``lens``.
    Returns (h, cache); h is (B, 1, D)."""
    check_ported(cfg, sig)
    y, cache = attn.attn_decode_paged(cfg, w["mixer"],
                                      norm_apply(cfg, w["ln1"], h), cache,
                                      block_tables, lens)
    return _ffn(cfg, w, h + y), cache


def apply_layer_prefill_paged(cfg: ModelConfig, sig: Sig, w, h: torch.Tensor,
                              cache: Dict, block_tables: torch.Tensor,
                              lens: torch.Tensor, n_valid: torch.Tensor,
                              aligned: bool = False):
    """One layer of a continuation-prefill chunk: like
    :func:`apply_layer_paged` over a (B, C, D) chunk of prompt tokens.
    ``aligned`` passes through to :func:`attn.attn_prefill_paged`."""
    check_ported(cfg, sig)
    y, cache = attn.attn_prefill_paged(cfg, w["mixer"],
                                       norm_apply(cfg, w["ln1"], h), cache,
                                       block_tables, lens, n_valid,
                                       aligned=aligned)
    return _ffn(cfg, w, h + y), cache
