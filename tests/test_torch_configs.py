"""The port's model configs equal the JAX package's, field for field."""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402

NAMES = sorted(REF_ARCHS)


def test_same_architectures():
    assert list(ARCHS) == list(REF_ARCHS)


@pytest.mark.parametrize("name", NAMES)
def test_fields_equal(name):
    assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(REF_ARCHS[name])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_equal(name, dtype):
    got, want = ARCHS[name].reduced(dtype=dtype), REF_ARCHS[name].reduced(dtype=dtype)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.d_inner, got.n_ssm_heads) == (want.hd, want.d_inner, want.n_ssm_heads)


@pytest.mark.parametrize("name", NAMES)
def test_param_count_equal(name):
    for cfg, ref in [(ARCHS[name], REF_ARCHS[name]),
                     (ARCHS[name].reduced(), REF_ARCHS[name].reduced())]:
        assert cfg.param_count() == ref.param_count()
        assert cfg.param_count(active_only=True) == ref.param_count(active_only=True)


def test_get_config_rejects_unknown():
    assert get_config("granite-20b") is ARCHS["granite-20b"]
    with pytest.raises(KeyError):
        get_config("gpt-5")
