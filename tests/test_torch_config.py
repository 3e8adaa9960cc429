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
