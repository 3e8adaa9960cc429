"""Convert the reference's parameters and decode caches to the port's
layout.

The input is the reference's parameter pytree with every leaf turned
into a numpy array (``jax.tree.map(np.asarray, params)``); this module
itself needs neither jax nor the reference package.  The reference
keeps its first ``first_k_dense`` layers in a list ``layers0`` and the
rest as a tuple of per-slot stacks ``layers``, each leaf with a leading
``n_periods`` axis (slot ``s`` of period ``p`` is global layer
``first_k + p * period + s``).  The port keeps one dict per layer, in
global order.  The reference's decode cache (``repro.models.init_cache``
and ``prefill``) has the same ``layers0`` / stacked ``layers`` layout;
the port's is a list with one dict per layer: ``{"k", "v"}`` for an
attention layer, ``{"ckv", "krope"}`` for MLA, ``{"conv", "state"}`` for
an SSM layer, ``{"ck", "cv"}`` for a cross layer (a hybrid such as jamba
stacks several kinds, one per slot of its period).  An encoder's layers
(``encoder["layers"]``, one slot stacked ``n_layers`` deep) become a
list of their own.  bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) are
carried bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["to_tensor", "convert_params", "convert_cache"]


def to_tensor(a, device: Union[str, torch.device]) -> torch.Tensor:
    """One numpy leaf as a tensor on ``device`` (bf16 kept bit-exact)."""
    a = np.asarray(a)
    # reshape: ascontiguousarray gives a 0-d leaf (a cross gate) one axis
    c = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(c.view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(c.copy()).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def convert_params(np_params: Dict, *,
                   device: Union[str, torch.device, None] = "cuda") -> Dict:
    """The port's parameter dict from the reference's numpy pytree."""
    dev = resolve_device(device)
    out: Dict = {k: _tree(v, lambda a: to_tensor(a, dev))
                 for k, v in np_params.items()
                 if k not in ("layers0", "layers", "encoder")}
    out["layers"] = _unstack(np_params, dev)
    if "encoder" in np_params:
        enc = np_params["encoder"]
        out["encoder"] = {k: _tree(v, lambda a: to_tensor(a, dev))
                          for k, v in enc.items() if k != "layers"}
        out["encoder"]["layers"] = _unstack({"layers": enc["layers"]}, dev)
    return out


def convert_cache(np_cache: Dict, *,
                  device: Union[str, torch.device, None] = "cuda"
                  ) -> List[Dict]:
    """The port's per-layer decode cache from the reference's numpy one,
    ``{"layers0": [...], "layers": (per-slot stacks,)}`` whose stacked
    leaves carry a leading n_periods axis: (n_periods, B, T, KV, hd) K/V
    of an attention slot, (n_periods, B, T, r) latents and RoPE keys of
    an MLA slot, (n_periods, B, d_conv - 1, conv_dim) conv windows and
    (n_periods, B, nh, hd, ds) states of an SSM slot, (n_periods, B, M,
    KV, hd) media K/V of a cross slot."""
    return _unstack(np_cache, resolve_device(device))


def _unstack(tree: Dict, dev: torch.device) -> List[Dict]:
    """``layers0`` then every period's slots, one dict per layer."""
    layers: List[Dict] = [_tree(w, lambda a: to_tensor(a, dev))
                          for w in tree.get("layers0", [])]
    slots = list(tree["layers"])
    if slots:
        n_periods = np.asarray(next(_leaves(slots[0]))).shape[0]
        for p in range(n_periods):
            for slot in slots:
                layers.append(_tree(slot, lambda a: to_tensor(a[p], dev)))
    return layers


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x
