"""Top-level LM assembly for paged serving (twin of the serving half of
``repro.models.model``).

Parameters are a plain dict: ``embed`` (V, D), ``final_norm``,
``unembed`` (D, V) unless embeddings are tied, and ``layers``, a list
with one weight dict per layer in global order.  The reference scans
over stacked per-period weights; here the scan is a Python loop over
that list (:mod:`repro_torch.convert` unstacks the reference's layout).

The KV pools are ``{"k", "v"}`` tensors of shape (L, P, page, KV, hd),
one (P, page, KV, hd) pool per layer, written in place by the steps
below (build them with :class:`repro_torch.serve.PagedKVCache`).
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (apply_layer_paged,
                                       apply_layer_prefill_paged, init_layer,
                                       init_norm, layer_sigs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cdtype, embed_apply, norm_apply,
                                       unembed_apply)

__all__ = ["init_params", "paged_decode_step", "paged_prefill_step"]


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: Union[str, torch.device, None] = "cuda") -> Dict:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), with the reference's initialisation scales."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: generator on {generator.device} "
                         f"cannot draw weights for device {dev}")
    dt = cdtype(cfg)
    s = 1.0 / math.sqrt(cfg.d_model)

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=dev)
                * s).to(dt)

    p: Dict = {"embed": normal((cfg.vocab_size, cfg.d_model)),
               "final_norm": init_norm(cfg, dev)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal((cfg.d_model, cfg.vocab_size))
    p["layers"] = [init_layer(cfg, generator, sig, dev)
                   for sig in layer_sigs(cfg)]
    return p


def _embed_in(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"paged serving needs per-request rope positions "
            f"(cfg.pos_embed={cfg.pos_embed!r})")
    return embed_apply(cfg, params["embed"], tokens)


def _logits_out(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = norm_apply(cfg, params["final_norm"], h)
    w_un = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return unembed_apply(cfg, w_un, h)


def _layer_cache(pools: Dict, i: int) -> Dict:
    return {"k": pools["k"][i], "v": pools["v"][i]}


def paged_decode_step(cfg: ModelConfig, params, pools: Dict,
                      tokens: torch.Tensor, block_tables: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
    """One continuous-batching decode tick over the block-paged pools.

    tokens (B, 1) int — each engine slot's pending token; block_tables
    (B, NB) int32 logical-to-physical block maps, shared by every layer;
    lens (B,) int32 per-request cache lengths (write index and RoPE
    position).  Writes each layer's new K/V row into ``pools`` in place
    and returns the (B, 1, V) f32 logits."""
    h = _embed_in(cfg, params, tokens)
    for i, (sig, w) in enumerate(zip(layer_sigs(cfg), params["layers"])):
        h, _ = apply_layer_paged(cfg, sig, w, h, _layer_cache(pools, i),
                                 block_tables, lens)
    return _logits_out(cfg, params, h)


def paged_prefill_step(cfg: ModelConfig, params, pools: Dict,
                       tokens: torch.Tensor, block_tables: torch.Tensor,
                       lens: torch.Tensor, n_valid: torch.Tensor, *,
                       aligned: bool = False) -> torch.Tensor:
    """One continuation-prefill chunk over the block-paged pools.

    tokens (B, C) int — a chunk of each request's uncached prompt
    suffix, right-padded past ``n_valid``; block_tables and lens as in
    :func:`paged_decode_step` (``lens`` is the chunk's global start).
    Writes the chunk's K/V into ``pools`` in place and returns the
    (B, 1, V) f32 logits at each request's last valid row (meaningful on
    the prompt's final chunk).  ``aligned`` forwards the single-block
    write promise to the attention layers."""
    h = _embed_in(cfg, params, tokens)
    for i, (sig, w) in enumerate(zip(layer_sigs(cfg), params["layers"])):
        h, _ = apply_layer_prefill_paged(cfg, sig, w, h,
                                         _layer_cache(pools, i),
                                         block_tables, lens, n_valid,
                                         aligned)
    last = (n_valid.long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    return _logits_out(cfg, params, torch.gather(h, 1, last))
