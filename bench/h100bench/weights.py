"""The cell's weights, drawn from the seed on the device.

The benchmark makes the weights and hands the same tensors to the
program (as the port's parameter dict, which it only reads) and to the
plain reference.  Each layer's bf16 matrices, norms and biases come from
one ``torch.randn`` call into a flat buffer, viewed and scaled in
place; the router (float32) and the embeddings from one call each.  The
scales are the port's initialisation scales; norm scales are
``1 + 0.1 N(0, 1)`` and Qwen2's q, k, v biases ``0.1 N(0, 1)``, so that
neither is the identity the reference could skip.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def dims(c: dict) -> dict:
    """The sizes the weights and the counts read from a config file."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    return {"D": D, "H": H, "KV": c["num_key_value_heads"],
            "hd": c.get("head_dim") or D // H, "L": c["num_hidden_layers"],
            "V": c["vocab_size"], "F": c.get("intermediate_size", 0),
            "E": c.get("num_experts", 0), "K": c.get("num_experts_per_tok", 0),
            "Fe": c.get("moe_intermediate_size", 0),
            "bias": bool(c.get("attention_bias", False)),
            "moe": "num_experts" in c}


def _layer_plan(d: dict) -> List[Tuple[Tuple[str, ...], tuple, str, float]]:
    """(path, shape, kind, std) of each bf16 leaf of one layer; kind is
    ``"w"`` (std N(0, 1)), ``"norm"`` or ``"bias"``."""
    D, H, KV, hd, L = d["D"], d["H"], d["KV"], d["hd"], d["L"]
    s = 1.0 / math.sqrt(D)
    plan = [(("ln1",), (D,), "norm", 0.1),
            (("mixer", "wq"), (D, H * hd), "w", s),
            (("mixer", "wk"), (D, KV * hd), "w", s),
            (("mixer", "wv"), (D, KV * hd), "w", s),
            (("mixer", "wo"), (H * hd, D), "w", s / math.sqrt(L)),
            (("ln2",), (D,), "norm", 0.1)]
    if d["bias"]:
        plan += [(("mixer", "bq"), (H * hd,), "bias", 0.1),
                 (("mixer", "bk"), (KV * hd,), "bias", 0.1),
                 (("mixer", "bv"), (KV * hd,), "bias", 0.1)]
    if d["moe"]:
        E, Fe = d["E"], d["Fe"]
        so = 1.0 / math.sqrt(Fe) / math.sqrt(L)
        plan += [(("ffn", "we_g"), (E, D, Fe), "w", s),
                 (("ffn", "we_i"), (E, D, Fe), "w", s),
                 (("ffn", "we_o"), (E, Fe, D), "w", so)]
    else:
        F = d["F"]
        so = 1.0 / math.sqrt(F) / math.sqrt(L)
        plan += [(("ffn", "wg"), (D, F), "w", s),
                 (("ffn", "wi"), (D, F), "w", s),
                 (("ffn", "wo"), (F, D), "w", so)]
    return plan


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_weights(c: dict, seed: int, device) -> Dict:
    """The weights of config file ``c`` from ``seed``, on ``device``, as
    the port's parameter dict: ``embed`` (V, D), ``unembed`` (D, V),
    ``final_norm`` (D,), ``layers`` with ``ln1``, ``ln2``, ``mixer``
    (``wq``, ``wk``, ``wv``, ``wo`` and Qwen2's biases) and ``ffn`` (a
    SwiGLU ``wg``, ``wi``, ``wo``, or the MoE ``router`` (f32, (D, E)),
    ``we_g``, ``we_i`` (E, D, F), ``we_o`` (E, F, D))."""
    d = dims(c)
    dt = DTYPES[c["torch_dtype"]]
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    D, V = d["D"], d["V"]
    s = 1.0 / math.sqrt(D)
    emb = torch.randn(2 * V * D + D, generator=gen, device=device, dtype=dt)
    params: Dict = {"embed": emb[:V * D].view(V, D).mul_(s),
                    "unembed": emb[V * D:2 * V * D].view(D, V).mul_(s),
                    "final_norm": emb[2 * V * D:].mul_(0.1).add_(1.0),
                    "layers": []}
    plan = _layer_plan(d)
    n = sum(math.prod(shape) for _, shape, _, _ in plan)
    for _ in range(d["L"]):
        buf = torch.randn(n, generator=gen, device=device, dtype=dt)
        layer: Dict = {}
        o = 0
        for path, shape, kind, std in plan:
            t = buf[o:o + math.prod(shape)].view(shape).mul_(std)
            if kind == "norm":
                t.add_(1.0)
            o += math.prod(shape)
            _put(layer, path, t)
        if d["moe"]:
            layer["ffn"]["router"] = torch.randn(
                (D, d["E"]), generator=gen, device=device,
                dtype=torch.float32).mul_(s)
        params["layers"].append(layer)
    return params
