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
    with pytest.raises(KeyError, match="not yet ported"):
        get_config("mamba2-370m")


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
