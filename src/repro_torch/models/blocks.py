"""Decoder blocks and layer schedules (twin of ``repro.models.blocks``).

A layer signature ``(mixer, is_moe)`` classifies every layer, as in the
reference: ``mixer`` is ``"attn"`` (GQA self-attention, or MLA when the
config has ``mla``), ``"ssm"`` (Mamba-2, :mod:`repro_torch.models.ssm`),
``"cross"`` (gated cross-attention over media embeddings, the VLM's
every ``cross_attn.period``-th layer), ``"attn_cross"`` (self-attention
then a cross-attention sub-block; no catalog config's schedule yields
it, as in the reference) or ``"enc_attn"`` (the encoder's non-causal
self-attention).  Every block is pre-norm with residuals:
``h += mixer(norm(h)); h += ffn(norm(h))``, the FFN a dense MLP or, for
an MoE signature, :func:`repro_torch.models.moe.moe_apply`; a block
without FFN (mamba2, ``d_ff = 0``) is the mixer alone.  A cross layer
scales its mixer's output by ``tanh(gate)`` in f32, the gate a learned
scalar initialised to zero.  :func:`apply_layer` runs the reference's
three modes (train, prefill, decode against the sync engine's cache).
Only plain GQA attention layers page (the two paged steps); other layer
kinds raise ``NotImplementedError``, as the reference's do.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, mlp_apply, mm, norm_apply
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.parallel.api import shard, write_rows

__all__ = ["Sig", "layer_sigs", "schedule", "init_norm", "init_mlp",
           "init_layer", "init_layer_cache", "apply_layer",
           "apply_layer_paged", "apply_layer_prefill_paged"]

Sig = Tuple[str, bool]

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
    mixer, is_moe = sig
    w: Dict = {"ln1": init_norm(cfg, device)}
    if mixer in ("attn", "enc_attn"):
        w["mixer"] = attn.init_mla(cfg, gen, device) \
            if cfg.mla and mixer == "attn" else attn.init_attn(cfg, gen, device)
    elif mixer == "ssm":
        w["mixer"] = ssm_mod.init_ssm(cfg, gen, device)
    elif mixer == "cross":
        w["mixer"] = attn.init_cross(cfg, gen, device)
        w["gate"] = torch.zeros((), dtype=torch.float32, device=device)
    elif mixer == "attn_cross":
        w["mixer"] = attn.init_attn(cfg, gen, device)
        w["lnx"] = init_norm(cfg, device)
        w["cross"] = attn.init_cross(cfg, gen, device)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if is_moe:
        w["ln2"] = init_norm(cfg, device)
        w["ffn"] = init_moe(cfg, gen, device)
    elif cfg.d_ff > 0:
        w["ln2"] = init_norm(cfg, device)
        w["ffn"] = init_mlp(cfg, gen, device)
    return w


def init_layer_cache(cfg: ModelConfig, sig: Sig, batch: int, max_len: int,
                     media_len: int = 0, *,
                     device: Union[str, torch.device]) -> Dict:
    """Zeroed decode cache of one layer: (batch, max_len, KV, hd) K/V for
    attention, the latent and RoPE key for MLA, the conv window and f32
    state for an SSM layer, (batch, media_len, KV, hd) media K/V
    (``ck``, ``cv``) for a cross layer (beside the self-attention K/V for
    ``attn_cross``)."""
    mixer = sig[0]
    if mixer == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, device=device)
    if mixer in ("cross", "attn_cross"):
        c = {} if mixer == "cross" else \
            attn.init_attn_cache(cfg, batch, max_len, device=device)
        shp = (batch, media_len, cfg.n_kv_heads, cfg.hd)
        c["ck"] = torch.zeros(shp, dtype=cdtype(cfg), device=device)
        c["cv"] = torch.zeros(shp, dtype=cdtype(cfg), device=device)
        return c
    if cfg.mla:
        return attn.init_mla_cache(cfg, batch, max_len, device=device)
    return attn.init_attn_cache(cfg, batch, max_len, device=device)


def _pad_cache(x: torch.Tensor, max_len: int) -> torch.Tensor:
    """Right-pad a (B, S, ...) prefill tensor with zeros to cache length."""
    if x.shape[1] > max_len:
        raise ValueError(f"prefill of {x.shape[1]} rows does not fit a cache "
                         f"of max_len {max_len}")
    out = x.new_zeros((x.shape[0], max_len) + tuple(x.shape[2:]))
    write_rows(out, 1, 0, x)
    return out


def _attn_prefill_cache(cfg: ModelConfig, w, x: torch.Tensor,
                        positions: torch.Tensor, max_len: int) -> Dict:
    """Recompute the prompt's K/V, or MLA's latent and RoPE key (as the
    reference does: cheap next to attention itself) and pad them to cache
    length."""
    if cfg.mla:
        c_kv, k_rope = attn._mla_latent(cfg, w, x, positions)
        return {"ckv": shard(_pad_cache(c_kv, max_len), *attn.MLA_CACHE_AXES),
                "krope": shard(_pad_cache(k_rope, max_len),
                               *attn.MLA_CACHE_AXES)}
    _, k, v = attn._qkv(cfg, w, x, positions)
    return {"k": shard(_pad_cache(k, max_len), *attn.CACHE_AXES),
            "v": shard(_pad_cache(v, max_len), *attn.CACHE_AXES)}


def _ssm_prefill_cache(cfg: ModelConfig, w, x: torch.Tensor) -> Dict:
    """Re-run the SSD scan for the final state, and keep the last
    d_conv - 1 pre-conv rows as the conv window (as the reference does;
    the projection is a plain product rounded to x's dtype)."""
    S = x.shape[1]
    zxbcdt = mm(x, w["in_proj"], out_dtype=x.dtype)
    _, xs, Bm, Cm, dtr = ssm_mod._split_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    _, _, h_final = ssm_mod._scan(cfg, w, xbc_raw, dtr)
    return {"conv": xbc_raw[:, S - (cfg.ssm.d_conv - 1):].clone(),
            "state": h_final}


def _ffn(cfg: ModelConfig, sig: Sig, w, h: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h + ffn(norm(h))`` and the FFN's aux loss (the MoE balance
    loss; a zero f32 scalar for a dense MLP or a block without FFN)."""
    if "ffn" not in w:
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    z = norm_apply(cfg, w["ln2"], h)
    if sig[1]:
        y, aux = moe_apply(cfg, w["ffn"], z)
    else:
        y = mlp_apply(cfg, w["ffn"], z)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def apply_layer(cfg: ModelConfig, sig: Sig, w, h: torch.Tensor, *,
                mode: str, positions: Optional[torch.Tensor] = None,
                media: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, pos: Optional[int] = None,
                max_len: int = 0):
    """One layer in the reference's modes:

    * ``"train"``: returns (h, aux);
    * ``"prefill"``: returns (h, aux, cache), the cache padded to
      ``max_len``;
    * ``"decode"``: returns (h, cache), h (B, 1, D); the cache is
      updated in place (attention writes its new row at ``pos``, MLA its
      latent and RoPE-key rows, an SSM layer its conv window and state;
      a cross layer reads the media K/V its prefill cached).

    ``media`` (B, M, D) is what a cross layer attends in train and
    prefill; its prefill cache is ``cross_kv(media)``, not padded.  An
    SSM layer's prefill cache is not padded either: its conv window and
    state do not grow with the sequence.  An ``"enc_attn"`` layer (the
    encoder's) runs non-causal self-attention in every mode and caches
    nothing.  ``aux`` is the MoE balance loss of an MoE layer, a zero f32
    scalar otherwise."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"apply_layer: unknown mode {mode!r}")
    mixer = sig[0]
    x = norm_apply(cfg, w["ln1"], h)
    new_cache: Dict = {}
    if mixer == "enc_attn":
        y = attn.attn_train(cfg, w["mixer"], x, positions, causal=False)
    elif mixer == "attn":
        if mode == "decode":
            step = attn.mla_decode if cfg.mla else attn.attn_decode
            y, new_cache = step(cfg, w["mixer"], x, cache, pos)
        else:
            train = attn.mla_train if cfg.mla else attn.attn_train
            y = train(cfg, w["mixer"], x, positions)
            if mode == "prefill":
                new_cache = _attn_prefill_cache(cfg, w["mixer"], x, positions,
                                                max_len)
    elif mixer == "ssm":
        if mode == "decode":
            y, new_cache = ssm_mod.ssm_decode(cfg, w["mixer"], x, cache, pos)
        else:
            y = ssm_mod.ssm_train(cfg, w["mixer"], x)
            if mode == "prefill":
                new_cache = _ssm_prefill_cache(cfg, w["mixer"], x)
    elif mixer == "cross":
        if mode == "decode":
            y = attn.cross_decode(cfg, w["mixer"], x, (cache["ck"],
                                                       cache["cv"]))
            new_cache = cache
        else:
            y = attn.cross_train(cfg, w["mixer"], x, media)
            if mode == "prefill":
                ck, cv = attn.cross_kv(cfg, w["mixer"], media)
                new_cache = {"ck": ck, "cv": cv}
        y = (torch.tanh(w["gate"]) * y.float()).to(y.dtype)
    elif mixer == "attn_cross":
        if mode == "decode":
            y, new_cache = attn.attn_decode(cfg, w["mixer"], x, cache, pos)
            xc = norm_apply(cfg, w["lnx"], h + y)
            y = y + attn.cross_decode(cfg, w["cross"], xc,
                                      (cache["ck"], cache["cv"]))
        else:
            y = attn.attn_train(cfg, w["mixer"], x, positions)
            if mode == "prefill":
                new_cache = _attn_prefill_cache(cfg, w["mixer"], x, positions,
                                                max_len)
                new_cache["ck"], new_cache["cv"] = attn.cross_kv(
                    cfg, w["cross"], media)
            xc = norm_apply(cfg, w["lnx"], h + y)
            y = y + attn.cross_train(cfg, w["cross"], xc, media)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    # laid out like the layer boundary: DTensor carries a partial sum
    # through linear ops where GSPMD reduces it, and a product of a
    # partial input with a gathered weight repeats on every rank
    h, aux = _ffn(cfg, sig, w, shard(h + y, "batch", "seq", None))
    if mode == "decode":
        return h, new_cache
    return (h, aux) if mode == "train" else (h, aux, new_cache)


def _check_pages(cfg: ModelConfig, sig: Sig, where: str) -> None:
    """Only plain GQA attention layers page: an SSM layer's state is O(1)
    and needs no pages, and MLA and cross layers cache other leaves
    (``PagedKVCache`` rejects such configs up front)."""
    if sig[0] != "attn" or cfg.mla:
        raise NotImplementedError(
            f"{where}: only plain GQA attention layers page (got mixer "
            f"{sig[0]!r}, mla={bool(cfg.mla)}); serve {cfg.name} with the "
            "sync ServeEngine")


def apply_layer_paged(cfg: ModelConfig, sig: Sig, w, h: torch.Tensor,
                      cache: Dict, block_tables: torch.Tensor,
                      lens: torch.Tensor):
    """One layer of a continuous-batching decode tick against the shared
    block-paged pool, with per-request positions ``lens``.
    Returns (h, cache); h is (B, 1, D)."""
    _check_pages(cfg, sig, "apply_layer_paged")
    y, cache = attn.attn_decode_paged(cfg, w["mixer"],
                                      norm_apply(cfg, w["ln1"], h), cache,
                                      block_tables, lens)
    return _ffn(cfg, sig, w, h + y)[0], cache


def apply_layer_prefill_paged(cfg: ModelConfig, sig: Sig, w, h: torch.Tensor,
                              cache: Dict, block_tables: torch.Tensor,
                              lens: torch.Tensor, n_valid: torch.Tensor,
                              aligned: bool = False):
    """One layer of a continuation-prefill chunk: like
    :func:`apply_layer_paged` over a (B, C, D) chunk of prompt tokens.
    ``aligned`` passes through to :func:`attn.attn_prefill_paged`."""
    _check_pages(cfg, sig, "apply_layer_prefill_paged")
    y, cache = attn.attn_prefill_paged(cfg, w["mixer"],
                                       norm_apply(cfg, w["ln1"], h), cache,
                                       block_tables, lens, n_valid,
                                       aligned=aligned)
    return _ffn(cfg, sig, w, h + y)[0], cache
