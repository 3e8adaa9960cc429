"""The port's ModelConfig twin against the reference's, field for field.

The only intended difference is the kernel flag: the reference's
``use_pallas`` / ``pallas_device`` pair becomes ``use_kernels``.
"""

import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCHS, get_config

_FLAGS_REF = {"use_pallas", "pallas_device"}
_FLAGS_PORT = {"use_kernels"}


def _fields(cfg, drop):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in drop}


def _plain(value):
    """Nested spec dataclasses as dicts, so the two packages compare."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, reduced):
    ref = jax_get_config(arch)
    port = get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    a = {k: _plain(v) for k, v in _fields(ref, _FLAGS_REF).items()}
    b = {k: _plain(v) for k, v in _fields(port, _FLAGS_PORT).items()}
    assert a == b
    assert port.hd == ref.hd
    assert [port.layer_kind(i) for i in range(port.n_layers)] == \
        [ref.layer_kind(i) for i in range(ref.n_layers)]


def test_kernel_flag_defaults_on():
    assert get_config("qwen2-7b").use_kernels is True
    assert get_config("qwen2-7b").reduced().use_kernels is True


def test_unported_arch_raises():
    """Every config of the reference's catalog is ported; a name in no
    catalog raises."""
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("gpt-2-1.5b")


def test_catalog_is_the_references():
    from repro.configs import ARCHS as REF_ARCHS
    assert ARCHS == REF_ARCHS and len(ARCHS) == 10


# arch: (n_layers, d_model, n_heads, n_kv_heads, hd, d_ff, vocab, family,
#        norm, mlp, positions, tied) of the full config, then the reduced
# config's (n_layers, d_model, n_heads, n_kv_heads, hd)
CATALOG_PINS = {
    "internlm2-20b": ((48, 6144, 48, 8, 128, 16384, 92544, "dense", "rms",
                       "swiglu", "rope", False), (4, 128, 4, 2, 32)),
    "mistral-nemo-12b": ((40, 5120, 32, 8, 128, 14336, 131072, "dense",
                          "rms", "swiglu", "rope", False), (4, 128, 4, 2, 32)),
    "yi-34b": ((60, 7168, 56, 8, 128, 20480, 64000, "dense", "rms", "swiglu",
                "rope", False), (4, 128, 4, 2, 32)),
    "deepseek-v2-lite-16b": ((27, 2048, 16, 16, 128, 10944, 102400, "moe",
                              "rms", "swiglu", "rope", False),
                             (4, 128, 4, 4, 32)),
    "llama-3.2-vision-90b": ((100, 8192, 64, 8, 128, 28672, 128256, "vlm",
                              "rms", "swiglu", "rope", False),
                             (4, 128, 4, 2, 32)),
    "whisper-base": ((6, 512, 8, 8, 64, 2048, 51865, "audio", "layer", "gelu",
                      "learned", True), (4, 128, 4, 4, 32)),
}


@pytest.mark.parametrize("arch", list(CATALOG_PINS))
def test_catalog_config_pinned(arch):
    """The six configs this slice serves: published widths, and the
    reduced variants the CPU tests run."""
    cfg = get_config(arch)
    full, small = CATALOG_PINS[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size, cfg.family, cfg.norm_type, cfg.mlp_type,
            cfg.pos_embed, cfg.tie_embeddings) == full
    r = cfg.reduced()
    assert (r.n_layers, r.d_model, r.n_heads, r.n_kv_heads, r.hd) == small
    if arch == "deepseek-v2-lite-16b":
        m, e = cfg.mla, cfg.moe
        assert (m.kv_lora_rank, m.q_lora_rank, m.qk_nope_dim, m.qk_rope_dim,
                m.v_head_dim) == (512, 0, 128, 64, 128)
        assert (e.n_experts, e.top_k, e.d_ff_expert, e.n_shared,
                e.d_ff_shared, cfg.first_k_dense) == (64, 6, 1408, 2, 2816, 1)
        assert [cfg.layer_is_moe(i) for i in range(3)] == [False, True, True]
        assert (r.mla.qk_nope_dim + r.mla.qk_rope_dim, r.mla.v_head_dim,
                r.moe.n_experts, r.moe.top_k, r.moe.d_ff_shared,
                r.first_k_dense) == (32, 16, 4, 2, 64, 1)
    if arch == "llama-3.2-vision-90b":
        assert (cfg.cross_attn.period, cfg.cross_attn.n_media_tokens) == \
            (5, 4100)
        assert (r.cross_attn.period, r.cross_attn.n_media_tokens) == (2, 16)
    if arch == "whisper-base":
        assert (cfg.encoder.n_layers, cfg.encoder.n_frames) == (6, 1500)
        assert (r.encoder.n_layers, r.encoder.n_frames) == (2, 32)


def test_moe_config_pinned():
    """The MoE slice's model: published widths, and the reduced variant
    the CPU tests run (4 experts, top-2)."""
    cfg = get_config("qwen3-moe-235b-a22b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size, cfg.family) == \
        (94, 4096, 64, 4, 128, 0, 151936, "moe")
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_ff_expert, m.n_shared,
            m.capacity_factor, m.router_aux_weight) == \
        (128, 8, 1536, 0, 1.25, 0.001)
    assert cfg.first_k_dense == 0
    assert all(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    small = cfg.reduced()
    assert (small.n_layers, small.d_model, small.moe.n_experts,
            small.moe.top_k, small.moe.d_ff_expert) == (4, 128, 4, 2, 64)
    assert small.use_kernels is True


def test_ssm_config_pinned():
    """mamba2-370m: published widths (48 SSM layers of 32 heads of 64,
    d_state 128, no FFN, tied embeddings) and the reduced variant."""
    cfg = get_config("mamba2-370m")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.family,
            cfg.tie_embeddings, cfg.pos_embed) == \
        (48, 1024, 0, 50280, "ssm", True, "none")
    s = cfg.ssm
    assert (s.d_state, s.d_conv, s.expand, s.head_dim, s.n_groups,
            s.chunk) == (128, 4, 2, 64, 1, 256)
    assert {cfg.layer_kind(i) for i in range(cfg.n_layers)} == {"ssm"}
    small = cfg.reduced()
    assert (small.n_layers, small.d_model, small.ssm.d_state,
            small.ssm.head_dim, small.ssm.chunk) == (4, 128, 16, 16, 32)


def test_hybrid_config_pinned():
    """jamba-v0.1-52b: one attention layer per 8 (offset 4), MoE every
    other layer; one period is the 8-layer cut the card serves."""
    cfg = get_config("jamba-v0.1-52b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size, cfg.family, cfg.pos_embed) == \
        (32, 4096, 32, 8, 128, 14336, 65536, "hybrid", "none")
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.period) == (16, 2, 14336, 2)
    assert (cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.expand) == (16, 64, 2)
    cut = dataclasses.replace(cfg, n_layers=8)
    kinds = [cut.layer_kind(i) for i in range(8)]
    assert kinds == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [cut.layer_is_moe(i) for i in range(8)] == [True, False] * 4
    small = cfg.reduced()
    assert [small.layer_kind(i) for i in range(small.n_layers)] == \
        ["ssm", "ssm", "ssm", "attn"] * 2
