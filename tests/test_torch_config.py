"""The port's configs equal the JAX package's: every field of all 10 archs
and of their tiny variants, the shape cells, and the parameter counts."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.configs as J  # noqa: E402
import repro_torch.configs as T  # noqa: E402

NAMES = sorted(J.ARCHS)


def test_same_archs():
    assert sorted(T.ARCHS) == NAMES


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal(name, tiny):
    get = "tiny_config" if tiny else "get_config"
    jc, tc = getattr(J, get)(name), getattr(T, get)(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert str(tc.torch_dtype).removeprefix("torch.") == str(jc.jnp_dtype)
    assert tc.num_layers == jc.num_layers
    assert tc.resolved_head_dim == jc.resolved_head_dim
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_shapes_equal():
    assert [dataclasses.asdict(s) for s in T.SHAPES] == \
        [dataclasses.asdict(s) for s in J.SHAPES]
    assert T.get_shape("decode_32k") == T.SHAPES[2]


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        T.get_config("no-such-arch")
