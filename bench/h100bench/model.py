"""The program's configuration, built from a config file and held to it.

A config file (``bench/configs/<name>.json``) names the port's config it
cuts (``port_config``) and holds every size as it is run, under the
published config's keys.  :func:`port_config` sets those sizes on the
port's ``ModelConfig`` and checks that the result is what the file
says, so the program cannot run another model than the one the
reference computes.
"""

from __future__ import annotations

import dataclasses

# published key -> the port's ModelConfig field (MoE keys: its MoESpec's)
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings",
          "attention_bias": "qkv_bias", "torch_dtype": "dtype"}
MOE_FIELDS = {"num_experts": "n_experts", "num_experts_per_tok": "top_k",
              "moe_intermediate_size": "d_ff_expert",
              "capacity_factor": "capacity_factor"}


def port_config(c: dict):
    """The port's ``ModelConfig`` for config file ``c``, kernels on."""
    from repro_torch.configs import get_config
    cfg = get_config(c["port_config"])
    kw = {f: c[k] for k, f in FIELDS.items() if k in c}
    moe = {f: c[k] for k, f in MOE_FIELDS.items() if k in c}
    if moe:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe)
    cfg = dataclasses.replace(cfg, use_kernels=True, **kw)
    checks = {"hidden_act": c.get("hidden_act") == "silu"
              and cfg.mlp_type == "swiglu",
              "norm": cfg.norm_type == "rms",
              "rope": cfg.pos_embed == "rope",
              "norm_topk_prob": cfg.moe is None
              or c.get("norm_topk_prob") is True}
    if cfg.moe:
        checks.update(shared=cfg.moe.n_shared == 0, period=cfg.moe.period == 1,
                      first_k_dense=cfg.first_k_dense == 0)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise ValueError(f"{c['port_config']}: the port's config departs "
                         f"from the config file in {bad}")
    return cfg
