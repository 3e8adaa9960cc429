"""Top-level LM assembly (twin of ``repro.models.model``).

Parameters are a plain dict: ``embed`` (V, D), ``final_norm``,
``unembed`` (D, V) unless embeddings are tied, ``pos_embed``
(:data:`LEARNED_POS_LEN`, D) for learned positions, ``layers``, a list
with one weight dict per layer in global order, and for an
encoder-decoder ``encoder = {"pos", "layers", "norm"}`` (its own list of
``"enc_attn"`` layers).  The reference scans over stacked per-period
weights; here the scan is a Python loop over those lists
(:mod:`repro_torch.convert` unstacks the reference's layout).

The layers follow the config's schedule of mixers (``layer_sigs``):
attention (GQA or MLA), SSM, gated cross-attention, or a hybrid of
them, each with a dense or MoE FFN or none.  Two cache layouts, both
written in place by the steps below:

* the decode cache of the sync serve engine, a list with one dict per
  layer: ``{"k", "v"}`` of (B, max_len, KV, hd) tensors for an
  attention layer, ``{"ckv", "krope"}`` (B, max_len, kv_lora_rank) and
  (B, max_len, qk_rope_dim) for MLA, ``{"conv", "state"}`` for an SSM
  layer, the last d_conv - 1 conv inputs (B, d_conv - 1, conv_dim) and
  the f32 state (B, nh, hd, ds), which do not grow with the sequence,
  and ``{"ck", "cv"}`` (B, media_len, KV, hd) for a cross layer, the
  media's K/V written by the prefill (:func:`init_cache`,
  :func:`prefill`, :func:`decode_step`);
* the paged pools, ``{"k", "v"}`` tensors of shape (L, P, page, KV, hd),
  one (P, page, KV, hd) pool per layer (:func:`paged_decode_step`,
  :func:`paged_prefill_step`; build them with
  :class:`repro_torch.serve.PagedKVCache`).  Only plain GQA attention
  layers with RoPE page: other models are served by the sync engine or
  through :func:`prefill` and :func:`decode_step`.

:func:`forward` runs the ``train`` and ``prefill`` modes, taking
``batch["media"]`` (B, M, D) for a cross-attention model and
``batch["frames"]`` (B, F, D) for an encoder-decoder, whose encoder
(:func:`_encode`) runs first and becomes the decoder's media, as in the
reference.  :func:`loss_fn` is the training loss (next-token CE in f32
from :func:`_chunked_ce`, plus the MoE balance loss), differentiated by
autograd on the plain path (``use_kernels=False``; the kernels have no
backward, as the reference's Pallas kernels have none).  In a train
forward that autograd records each layer runs under :func:`_remat`,
the config's activation-checkpoint policy.

Sharding: :func:`param_axes_rule` and :func:`cache_axes_rule` give each
parameter and cache leaf its logical axes (the reference's leaf rules,
keyed on the same leaf names; the port's per-layer leaves have no
leading stack dim); :func:`param_logical_axes` and
:func:`cache_logical_axes` map whole trees.  Under a mesh
(:func:`repro_torch.parallel.set_mesh`) with DTensor parameters the
residual stream is laid out at the reference's sites (:func:`shard`);
without one every annotation is the identity.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (apply_layer, apply_layer_paged,
                                       apply_layer_prefill_paged, init_layer,
                                       init_layer_cache, init_norm,
                                       layer_sigs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cdtype, embed_apply, model_axis,
                                       norm_apply, unembed_apply)
from repro_torch.parallel.api import current_mesh, mesh_sizes, shard
from repro_torch.tree import leaves, tree_map_with_path

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill", "paged_decode_step", "paged_prefill_step",
           "LEARNED_POS_LEN", "param_axes_rule", "param_logical_axes",
           "cache_axes_rule", "cache_logical_axes"]

LEARNED_POS_LEN = 32768  # rows of the learned-position table, as the reference
ENC_SIG = ("enc_attn", False)
# the products whose outputs remat "dots" keeps (jax's checkpoint_dots)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
         torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` (one layer of a train forward) under the config's
    activation-checkpoint policy: ``"full"`` recomputes all of it in the
    backward, ``"dots"`` keeps the matmul outputs and recomputes the
    rest, ``"none"`` keeps everything."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _layer_runner(cfg: ModelConfig, params):
    """Wraps a layer of a train forward in :func:`_remat` when autograd
    records the forward (grad mode on and a parameter requires grad);
    otherwise nothing is kept for a backward and the layer runs as is."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in leaves(params)):
        return functools.partial(_remat, cfg)
    return lambda fn: fn


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
    if cfg.pos_embed == "learned":
        p["pos_embed"] = (torch.randn((LEARNED_POS_LEN, cfg.d_model),
                                      generator=generator, device=dev)
                          * 0.01).to(dt)
    p["layers"] = [init_layer(cfg, generator, sig, dev)
                   for sig in layer_sigs(cfg)]
    if cfg.encoder:
        e = cfg.encoder
        p["encoder"] = {
            "pos": (torch.randn((e.n_frames, cfg.d_model), generator=generator,
                                device=dev) * 0.01).to(dt),
            "layers": [init_layer(cfg, generator, ENC_SIG, dev)
                       for _ in range(e.n_layers)],
            "norm": init_norm(cfg, dev)}
    return p


# ---------------------------------------------------------------------------
# logical axes for sharding (leaf name -> trailing-dims rule; any leading
# dims get None)
# ---------------------------------------------------------------------------

_LEAF_RULES = {
    "embed": ("vocab", "fsdp"),
    "unembed": ("fsdp", "vocab"),
    "pos_embed": (None, "fsdp"),
    "pos": (None, "fsdp"),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "wi": ("fsdp", "tp"), "wg": ("fsdp", "tp"),
    "w_dkv": ("fsdp", None), "w_uk": (None, "tp"), "w_uv": (None, "tp"),
    "router": ("fsdp", None),
    "we_g": ("expert", "fsdp", None), "we_i": ("expert", "fsdp", None),
    "we_o": ("expert", None, "fsdp"),
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"), "conv_b": ("tp",),
}


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _trailing(core: Tuple, nd: int) -> Tuple:
    if len(core) > nd:
        core = core[len(core) - nd:]
    return (None,) * (nd - len(core)) + tuple(core)


def param_axes_rule(path, leaf) -> Tuple:
    """Logical axes of one parameter leaf, by its name (the last string
    key of ``path``) and rank."""
    return _trailing(_LEAF_RULES.get(_leaf_name(path), ()), len(leaf.shape))


def param_logical_axes(params) -> Dict:
    """Tree of logical-axis tuples matching ``params``."""
    return tree_map_with_path(param_axes_rule, params)


def cache_axes_rule(path, leaf) -> Tuple:
    """Logical axes of one decode-cache leaf."""
    name = _leaf_name(path)
    if name in ("k", "v", "ck", "cv"):
        core = ("batch", "kv_seq", None, None)
    elif name in ("ckv", "krope"):
        core = ("batch", "kv_seq", None)
    elif name == "conv":
        core = ("batch", None, "tp")
    elif name == "state":
        core = ("batch", "heads", None, None)
    else:
        core = ()
    return _trailing(core, len(leaf.shape))


def cache_logical_axes(cfg: ModelConfig, cache) -> List:
    """Logical axes of the decode cache, leaf for leaf."""
    return tree_map_with_path(cache_axes_rule, cache)


def _encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over frame embeddings (B, F, D): learned positions,
    ``cfg.encoder.n_layers`` non-causal self-attention blocks (flash
    attention with S = T = F under ``cfg.use_kernels``), a final norm."""
    enc = params["encoder"]
    F = frames.shape[1]
    h = shard(frames.to(cdtype(cfg)) + enc["pos"][None, :F], "batch", None,
              None)
    positions = torch.arange(F, dtype=torch.int32, device=frames.device)

    def layer(hh, w):
        return apply_layer(cfg, ENC_SIG, w, hh, mode="train",
                           positions=positions)[0]

    layer = _layer_runner(cfg, params)(layer)
    for w in enc["layers"]:
        h = layer(h, w)
    return norm_apply(cfg, enc["norm"], h)


def _embed_in(cfg: ModelConfig, params, tokens: torch.Tensor,
              pos0: Optional[int] = None) -> torch.Tensor:
    """Token embeddings, plus learned position embeddings from ``pos0``
    (default 0) when the config has them."""
    h = embed_apply(cfg, params["embed"], tokens)
    if cfg.pos_embed == "learned":
        S = tokens.shape[1]
        start = 0 if pos0 is None else int(pos0)
        h = h + params["pos_embed"][None, start:start + S]
    return h


def _paged_embed_in(cfg: ModelConfig, params,
                    tokens: torch.Tensor) -> torch.Tensor:
    if cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"paged serving needs per-request rope positions "
            f"(cfg.pos_embed={cfg.pos_embed!r})")
    return _embed_in(cfg, params, tokens)


def _logits_out(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = norm_apply(cfg, params["final_norm"], h)
    w_un = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return unembed_apply(cfg, w_un, h)


def forward(cfg: ModelConfig, params, batch: Dict, *, mode: str = "train",
            max_len: int = 0, last_pos: Optional[int] = None,
            with_hidden: bool = False):
    """``batch["tokens"]`` (B, S) int, with ``batch["media"]`` (B, M, D)
    for a cross-attention model or ``batch["frames"]`` (B, F, D) for an
    encoder-decoder (encoded first, then the decoder's media; whisper's
    decoder layers are plain self-attention, so, as in the reference,
    its logits do not read them).  Returns (logits, aux) in mode
    ``"train"``, logits (B, S, V) f32; (logits, aux, cache) in mode
    ``"prefill"``, logits (B, 1, V) f32 at the last position or at
    ``last_pos`` (the true last token of right-padded prompts), the cache
    padded to ``max_len``.
    ``aux`` is the sum of the layers' MoE balance losses, a zero f32
    scalar for a dense model.  ``with_hidden`` (mode ``"train"``)
    returns (None, aux, h) instead, h (B, S, D) the final-normed hidden
    states, for the loss to form its logits chunk by chunk.  When
    autograd records it, a train forward runs each layer under
    :func:`_remat`."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode must be 'train' or 'prefill', got "
                         f"{mode!r}")
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    media = batch.get("media")
    if cfg.encoder:
        media = _encode(cfg, params, batch["frames"])
    h = _embed_in(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cache: List[Dict] = []
    if mode == "train":
        run = _layer_runner(cfg, params)
        for sig, w in zip(layer_sigs(cfg), params["layers"]):
            layer = run(functools.partial(
                apply_layer, cfg, sig, mode="train", positions=positions,
                media=media))
            h, a = layer(w, h)
            h = shard(h, "batch", "seq", None)
            aux = aux + a
        if with_hidden:
            return None, aux, shard(norm_apply(cfg, params["final_norm"], h),
                                    "batch", "seq", None)
        return _logits_out(cfg, params, h), aux
    for sig, w in zip(layer_sigs(cfg), params["layers"]):
        h, a, c = apply_layer(cfg, sig, w, h, mode=mode, positions=positions,
                              media=media, max_len=max_len)
        h = shard(h, "batch", "seq", None)
        aux = aux + a
        cache.append(c)
    # only the last position's logits are needed: slice before the unembed
    lp = S - 1 if last_pos is None else int(last_pos)
    return _logits_out(cfg, params, h[:, lp:lp + 1]), aux, cache


def loss_fn(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (f32) plus the MoE balance loss:
    (ce + aux, {"ce", "aux"}), 0-d f32 tensors.  ``batch`` is
    :func:`forward`'s with ``labels`` (B, S) int."""
    _, aux, h = forward(cfg, params, batch, mode="train", with_hidden=True)
    w_un = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    ce = _chunked_ce(cfg, h, w_un, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


def _chunked_ce(cfg: ModelConfig, h: torch.Tensor, w_un: torch.Tensor,
                labels: torch.Tensor, n_chunks: int = 4) -> torch.Tensor:
    """mean(logsumexp(logits) - logit[label]) over (B, S), in chunks of
    the batch dimension (``n_chunks``, reduced until it divides B).  Each
    chunk's (bc, S, V) f32 logits are recomputed in the backward
    (checkpointed), so only one chunk's logits live at a time.  The
    correct-class logit is a masked sum over the vocabulary, as the
    reference forms it, not a gather."""
    B, S, _ = h.shape
    V = w_un.shape[-1]
    # chunks stay divisible by the batch-shard count under a mesh
    mesh = current_mesh()
    shard_n = 1
    if mesh is not None:
        sizes = mesh_sizes(mesh)
        shard_n = sizes.get("data", 1) * sizes.get("pod", 1)
    while n_chunks > 1 and (B % n_chunks or (B // n_chunks) % shard_n):
        n_chunks -= 1
    bc = B // n_chunks
    vocab = torch.arange(V, device=h.device)

    def chunk_ce(h_c, lab_c):
        logits = unembed_apply(cfg, w_un, h_c)               # (bc, S, V) f32
        if V % model_axis() == 0:
            logits = shard(logits, "batch", None, "vocab")
        else:
            logits = shard(logits, "batch", "seq", None)
        lse = torch.logsumexp(logits, dim=-1)
        eq = lab_c[..., None] == vocab
        correct = torch.where(eq, logits, 0.0).sum(-1)
        return torch.sum(lse - correct)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        rows = slice(i * bc, (i + 1) * bc)
        total = total + checkpoint(chunk_ce, h[rows], labels[rows],
                                   use_reentrant=False)
    return total / (B * S)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               media_len: int = 0, *,
               device: Union[str, torch.device, None] = "cuda"
               ) -> List[Dict]:
    """Zeroed decode cache, one dict per layer (see the module
    docstring).  ``media_len`` (the cross layers' media rows) defaults to
    the encoder's frames or the config's media tokens, as the
    reference's does."""
    dev = resolve_device(device)
    if cfg.encoder and media_len == 0:
        media_len = cfg.encoder.n_frames
    if cfg.cross_attn and media_len == 0:
        media_len = cfg.cross_attn.n_media_tokens
    return [init_layer_cache(cfg, sig, batch, max_len, media_len, device=dev)
            for sig in layer_sigs(cfg)]


def decode_step(cfg: ModelConfig, params, cache: List[Dict],
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step.  tokens (B, 1) int; ``pos`` (an int) is the write
    index, the number of tokens already in the cache.  Updates ``cache``
    in place (each attention layer's new K/V row, each MLA layer's latent
    and RoPE-key rows, each SSM layer's conv window and state; a cross
    layer reads the media K/V the prefill cached) and returns the
    (B, 1, V) f32 logits and the cache."""
    h = _embed_in(cfg, params, tokens, pos0=pos)
    for sig, w, c in zip(layer_sigs(cfg), params["layers"], cache):
        h, _ = apply_layer(cfg, sig, w, h, mode="decode", cache=c, pos=pos)
        h = shard(h, "batch", "seq", None)
    return _logits_out(cfg, params, h), cache


def prefill(cfg: ModelConfig, params, batch: Dict, max_len: int,
            last_pos: Optional[int] = None
            ) -> Tuple[torch.Tensor, List[Dict]]:
    """Process a prompt (``batch`` as in :func:`forward`): returns the
    (B, 1, V) f32 logits of its last position (or ``last_pos``) and the
    filled cache, padded to ``max_len`` (a cross layer's media K/V are
    not padded)."""
    logits, _, cache = forward(cfg, params, batch, mode="prefill",
                               max_len=max_len, last_pos=last_pos)
    return logits[:, -1:], cache


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
    h = _paged_embed_in(cfg, params, tokens)
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
    h = _paged_embed_in(cfg, params, tokens)
    for i, (sig, w) in enumerate(zip(layer_sigs(cfg), params["layers"])):
        h, _ = apply_layer_prefill_paged(cfg, sig, w, h,
                                         _layer_cache(pools, i),
                                         block_tables, lens, n_valid,
                                         aligned)
    last = (n_valid.long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    return _logits_out(cfg, params, torch.gather(h, 1, last))
