"""The port's scan wrappers on the CPU (their plain versions) against the
JAX package: `selective_scan` vs `selective_scan_pallas` in interpret mode
at `tests/test_kernels.py`'s shapes, with and without h0, and vs
`selective_scan_ref` at a ragged shape the Pallas kernel refuses;
`ssm_scan` vs `ssm_scan_pallas`. The CUDA kernels run only on the card,
where chip_smoke.py holds them against the plain versions.
Tolerances are tests/test_kernels.py's: y 1e-4 (f32) and 3e-2 (bf16, one
rounding of the output), h_last 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssm_scan import (  # noqa: E402
    selective_scan_pallas, ssm_scan_pallas)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssm_scan import selective_scan, ssm_scan  # noqa: E402

SCAN_SHAPES = [(1, 128, 64, 8), (2, 256, 128, 16), (1, 512, 256, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
TOL_H = 1e-3


def _both(a, jdt=jnp.float32, tdt=torch.float32):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _sel_inputs(shape, dtype, seed=0, with_h0=False):
    """(jax args, torch args) of selective_scan, made with numpy: x, dt, b
    and c in `dtype`; a_log, d and h0 in f32 (tests/test_kernels.py's
    scales)."""
    b, s, d, n = shape
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    arrays = [(rng.randn(b, s, d), True),
              (np.logaddexp(rng.randn(b, s, d), 0) * 0.1, True),
              (rng.randn(d, n) * 0.1, False),
              (rng.randn(b, s, n) * 0.5, True),
              (rng.randn(b, s, n) * 0.5, True),
              (np.full((d,), 0.5), False)]
    if with_h0:
        arrays.append((rng.randn(b, d, n), False))
    pairs = [_both(a, jdt, tdt) if act else _both(a) for a, act in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_selective_scan_matches_pallas(shape, dtype, with_h0):
    jargs, targs = _sel_inputs(shape, dtype, with_h0=with_h0)
    y, h = selective_scan(*targs)
    b, s, d, n = shape
    assert y.dtype == DTYPES[dtype][1] and y.shape == (b, s, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    jy, jh = selective_scan_pallas(*jargs, blk_t=64, blk_d=64,
                                   interpret=True)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(y), _f32(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(h), _f32(jh), rtol=TOL_H, atol=TOL_H)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_selective_scan_ragged_matches_ref(dtype):
    """S, D and N that divide no tile: the Pallas kernel refuses them, the
    port (and its CUDA kernel, through masks) does not."""
    shape = (2, 100, 40, 5)
    jargs, targs = _sel_inputs(shape, dtype, seed=1, with_h0=True)
    with pytest.raises(AssertionError):
        selective_scan_pallas(*jargs, blk_t=64, blk_d=64, interpret=True)
    y, h = selective_scan(*targs)
    jy, jh = jref.selective_scan_ref(*jargs)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(y), _f32(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(h), _f32(jh), rtol=TOL_H, atol=TOL_H)


def test_selective_scan_carries_state_across_calls():
    """Two calls with h0 = the first call's h_last equal one call over the
    whole sequence (what a chunked prefill relies on)."""
    _, (x, dt, a_log, b, c, d) = _sel_inputs((2, 96, 32, 16), "float32", 2)
    y, h = selective_scan(x, dt, a_log, b, c, d)
    y1, h1 = selective_scan(x[:, :40], dt[:, :40], a_log, b[:, :40],
                            c[:, :40], d)
    y2, h2 = selective_scan(x[:, 40:], dt[:, 40:], a_log, b[:, 40:],
                            c[:, 40:], d, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h2, h, rtol=1e-6, atol=1e-6)


def test_selective_scan_takes_strided_b_c():
    """B and C as column slices of one [B,S,dt_rank + 2N] tensor, as the
    Mamba layer hands them over, give what contiguous copies give."""
    _, (x, dt, a_log, _, _, d) = _sel_inputs((1, 64, 32, 16), "float32", 3)
    dbc = torch.from_numpy(
        np.random.RandomState(4).randn(1, 64, 4 + 32).astype(np.float32))
    b, c = dbc[..., 4:20], dbc[..., 20:]
    assert not b.is_contiguous()
    got = selective_scan(x, dt, a_log, b, c, d)
    want = selective_scan(x, dt, a_log, b.contiguous(), c.contiguous(), d)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 128, 512)])
def test_ssm_scan_matches_pallas(shape, with_h0):
    b, s, d = shape
    rng = np.random.RandomState(5)
    ja, ta = _both(1 / (1 + np.exp(-rng.randn(b, s, d))))
    jbx, tbx = _both(rng.randn(b, s, d))
    jh0, th0 = _both(rng.randn(b, d)) if with_h0 else (None, None)
    got = ssm_scan(ta, tbx, th0)
    assert got.dtype == torch.float32 and got.shape == shape
    want = ssm_scan_pallas(ja, jbx, jh0, blk_t=32, blk_d=128, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_ssm_scan_bf16_ragged_matches_ref():
    b, s, d = 2, 37, 50
    rng = np.random.RandomState(6)
    ja, ta = _both(1 / (1 + np.exp(-rng.randn(b, s, d))), jnp.bfloat16,
                   torch.bfloat16)
    jbx, tbx = _both(rng.randn(b, s, d), jnp.bfloat16, torch.bfloat16)
    jh0, th0 = _both(rng.randn(b, d))
    got = ssm_scan(ta, tbx, th0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(jref.ssm_scan_ref(ja, jbx,
                                                                 jh0)),
                               rtol=3e-2, atol=3e-2)


def test_ops_route_cpu_tensors_to_the_plain_versions():
    assert ops.selective_scan is selective_scan and ops.ssm_scan is ssm_scan
    _, args = _sel_inputs((1, 16, 8, 4), "float32")
    before = (selective_scan.launches, ssm_scan.launches)
    y, h = ops.selective_scan(*args)
    yr, hr = ref.selective_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    a = torch.rand(1, 16, 8)
    assert torch.equal(ops.ssm_scan(a, args[0]), ref.ssm_scan_ref(a, args[0]))
    assert (selective_scan.launches, ssm_scan.launches) == before


def test_scan_wrappers_reject_bad_operands():
    _, (x, dt, a_log, b, c, d) = _sel_inputs((1, 16, 8, 4), "float32")
    with pytest.raises(ValueError, match="a_log"):
        selective_scan(x, dt, a_log[:4], b, c, d)
    with pytest.raises(ValueError, match="h0"):
        selective_scan(x, dt, a_log, b, c, d, h0=torch.zeros(1, 8, 5))
    with pytest.raises(TypeError):
        selective_scan(x, dt.to(torch.bfloat16), a_log, b, c, d)
    with pytest.raises(ValueError, match="cuda or cpu"):
        selective_scan(*(t.to("meta") for t in (x, dt, a_log, b, c, d)))
    with pytest.raises(ValueError, match="bx"):
        ssm_scan(x, x[:, :8])
    with pytest.raises(TypeError):
        ssm_scan(x, x.double())
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssm_scan(x.to("meta"), x.to("meta"))


def test_cpu_plain_versions_keep_autograd():
    """On the CPU the wrappers are the plain versions, differentiable by
    autograd (only a CUDA call, with no backward kernel, raises)."""
    _, (x, dt, a_log, b, c, d) = _sel_inputs((1, 8, 4, 4), "float32")
    x.requires_grad_()
    y, _ = selective_scan(x, dt, a_log, b, c, d)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
