"""The chunkwise mLSTM's plain mirror (`ref.mlstm_scan_chunkwise_ref`, the
two passes the kernels in csrc/xlstm_scan.cu take) against a `lax.scan`
of JAX's `_mlstm_step` and against the step recurrence
(`ref.mlstm_scan_ref`): ragged and short sequences, extreme gates, the
chunk-start states against the step recurrence's carry, and the distance
from a float64 run. Then the sLSTM cell's short formulas (the kernel's
`fast_*` functions), modelled in torch f32, against torch's own functions.

Tolerance 1e-5, relative (|diff| <= 1e-5 (1 + |want|)): the chunkwise
form sums the same terms as the step recurrence in another order, f32
products throughout, its gate sums in float64.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    mlstm_chunk_states_ref, mlstm_scan_chunkwise_ref, mlstm_scan_ref,
    mlstm_step)

TOL = 1e-5


def _inputs(b, s, h, hd, seed=0, f_bias=3.0, i_scale=1.0, i_bias=0.0):
    """q (scaled by hd**-0.5), k, v [B,S,H,hd]; i, f [B,S,H] as the layer
    makes them (f biased open by b_f = 3 unless `f_bias` says otherwise)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)) * hd ** -0.5
    k, v = (rng.standard_normal((b, s, h, hd)) for _ in range(2))
    i = rng.standard_normal((b, s, h)) * i_scale + i_bias
    f = rng.standard_normal((b, s, h)) + f_bias
    return [t.astype(np.float32) for t in (q, k, v, i, f)]


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= tol, err.max()


def _lax_scan(ins):
    b, s, h, hd = ins[0].shape
    carry = (jnp.zeros((b, h, hd, hd)), jnp.zeros((b, h, hd)),
             jnp.zeros((b, h)))
    xs = tuple(jnp.moveaxis(jnp.asarray(t), 1, 0) for t in ins)
    _, ys = jax.lax.scan(jax_ssm._mlstm_step, carry, xs)
    return np.moveaxis(np.asarray(ys), 0, 1)


# (chunk, hd, S): S = 1, S < chunk, S not a multiple of chunk, S a multiple
CASES = [(16, 16, 1), (16, 16, 11), (16, 16, 53), (16, 16, 64),
         (64, 16, 1), (64, 16, 40), (64, 16, 150), (64, 192, 1),
         (64, 192, 70), (16, 192, 37)]


@pytest.mark.parametrize("chunk,hd,s", CASES)
def test_mirror_matches_lax_scan_and_step_recurrence(chunk, hd, s):
    ins = _inputs(2, s, 2, hd, seed=s + hd)
    got = mlstm_scan_chunkwise_ref(*map(torch.from_numpy, ins), chunk)
    assert got.shape == (2, s, 2, hd) and got.dtype == torch.float32
    _close(got, _lax_scan(ins))
    _close(got, mlstm_scan_ref(*map(torch.from_numpy, ins)))


# forget gates nearly shut, input gates large, input gates far below 0
GATES = {"f shut": dict(f_bias=-8.0), "i large": dict(i_scale=5.0,
                                                       i_bias=8.0),
         "i very negative": dict(i_scale=5.0, i_bias=-30.0),
         "mixed": dict(f_bias=-2.0, i_scale=10.0)}


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("gates", sorted(GATES))
def test_mirror_at_extreme_gates(gates, chunk):
    ins = _inputs(2, 150, 2, 16, seed=7, **GATES[gates])
    got = mlstm_scan_chunkwise_ref(*map(torch.from_numpy, ins), chunk)
    assert bool(torch.isfinite(got).all())
    _close(got, mlstm_scan_ref(*map(torch.from_numpy, ins)))
    _close(got, _lax_scan(ins))


@pytest.mark.parametrize("chunk,hd,s", [(16, 16, 100), (64, 16, 200),
                                        (64, 192, 130)])
def test_chunk_start_states_are_the_step_carry(chunk, hd, s):
    """The first pass's state before chunk j equals the step recurrence's
    carry after step j chunk - 1 (stabilised C, n and m; chunk 0's is
    zero)."""
    ins = [torch.from_numpy(t) for t in _inputs(2, s, 2, hd, seed=3)]
    q, k, v, i, f = ins
    cs, ns, ms = mlstm_chunk_states_ref(k, v, i, f, chunk)
    nch = -(-s // chunk)
    assert cs.shape == (2, 2, nch, hd, hd) and ns.shape == (2, 2, nch, hd)
    assert ms.shape == (2, 2, nch)
    carry = (torch.zeros(2, 2, hd, hd), torch.zeros(2, 2, hd),
             torch.zeros(2, 2))
    for t in range(s):
        if t % chunk == 0:
            j = t // chunk
            for got, want in zip((cs[:, :, j], ns[:, :, j], ms[:, :, j]),
                                 carry):
                _close(got, want)
        carry, _ = mlstm_step(carry, q[:, t], k[:, t], v[:, t], i[:, t],
                              f[:, t])


@pytest.mark.parametrize("chunk,hd", [(64, 16), (16, 16), (64, 64)])
def test_mirror_f32_distance_from_float64(chunk, hd):
    """At S = 2048 the chunkwise form's f32 error against a float64 run of
    the step recurrence is at most twice the step recurrence's own."""
    ins = [torch.from_numpy(t) for t in _inputs(1, 2048, 2, hd, seed=11)]
    want = mlstm_scan_ref(*(t.double() for t in ins))
    step = (mlstm_scan_ref(*ins).double() - want).abs().max().item()
    chunked = (mlstm_scan_chunkwise_ref(*ins, chunk).double()
               - want).abs().max().item()
    assert chunked <= 2.0 * step, (chunked, step)


# ---- the sLSTM cell's short forms (csrc/xlstm_scan.cu: ex2_approx,
# fast_rcp, fast_exp, fast_log1p, fast_log_sigmoid, fast_tanh,
# fast_sigmoid), modelled in f32: ex2.approx.ftz by torch.exp2 with its
# results below 2^-126 flushed to 0, rcp.approx by an f32 division (the
# Newton step as the kernel takes it), fmaf by one rounding from float64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _ex2(x):
    y = torch.exp2(x)
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def _rcp(x):
    r = 1.0 / x
    return _fma(_fma(-x, r, torch.ones_like(x)), r, r)


def _exp(x):
    return _ex2(x * LOG2E)


def _log1p(e):
    s = e * _rcp(2.0 + e)
    w = s * s
    p = torch.full_like(e, 1 / 15)
    for k in (13, 11, 9, 7, 5, 3, 1):
        p = _fma(p, w, torch.full_like(e, 1 / k))
    return 2.0 * s * p


def _log_sigmoid(x):
    return torch.minimum(x, torch.zeros_like(x)) - _log1p(_exp(-x.abs()))


def _tanh(z):
    cap = torch.full_like(z, 126.0)
    return 1.0 - 2.0 * _rcp(1.0 + _ex2(torch.minimum((2.0 * LOG2E) * z, cap)))


def _sigmoid(x):
    cap = torch.full_like(x, 126.0)
    return _rcp(1.0 + _ex2(torch.minimum(-LOG2E * x, cap)))


# -90 .. 90, 0 and the edges: e = exp(-|x|) at 2^-12 (where 1 + e would
# first lose e's low bits in a log of 1 + e), exp's overflow and ftz ends
CUT = 12 * math.log(2)
GRID = torch.cat([torch.linspace(-90, 90, 20001),
                  torch.tensor([0.0, 1e-8, -1e-8, 1e-30, CUT, -CUT,
                                CUT * (1 + 1e-6), CUT * (1 - 1e-6), 87.3,
                                -87.3, 88.8, -88.8, 90.0, -90.0])]).float()

# (model, torch's function, abs tol, rel tol): the f32 results' own
# rounding (an ulp of 1 is 1.2e-7; min(x, 0) - log1p at |x| = 90 rounds at
# 3.8e-6), e^x's argument x log2(e) rounded to f32 (relative 2^-24 |x|
# log2(e): up to 3.6e-6 of e^x at |x| = 90) and ftz (results below 2^-126
# are 0)
SHORT_FORMS = {
    "log_sigmoid": (_log_sigmoid, torch.nn.functional.logsigmoid, 5e-7,
                    4e-6),
    "tanh": (_tanh, torch.tanh, 2.5e-7, 0.0),
    "sigmoid": (_sigmoid, torch.sigmoid, 1e-7, 4e-6),
    "exp(-|x|)": (lambda x: _exp(-x.abs()), lambda x: torch.exp(-x.abs()),
                  2.0 ** -126, 4e-6),
}


@pytest.mark.parametrize("name", sorted(SHORT_FORMS))
def test_slstm_short_forms_against_torch(name):
    model, want_fn, atol, rtol = SHORT_FORMS[name]
    got = model(GRID)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    want = want_fn(GRID.double())
    err = (got.double() - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), err.max()
    # within a few of torch's own f32 function's error
    f32 = (want_fn(GRID).double() - want).abs()
    assert err.max() <= 16 * f32.max() + 2.0 ** -126


def test_slstm_short_forms_at_the_ends():
    ends = torch.tensor([-90.0, 90.0, 0.0])
    assert _tanh(ends).tolist() == [-1.0, 1.0, 0.0]
    assert _sigmoid(ends).tolist()[1:] == [1.0, 0.5]
    assert 0.0 <= _sigmoid(ends)[0].item() < 1e-37
    assert abs(_log_sigmoid(ends)[2].item() + math.log(2)) < 1e-7


def test_slstm_log1p_series_keeps_relative_accuracy():
    """log1p(e) by 2 atanh(e / (2 + e)) stays within 4e-7 relative for e
    from 1 down to 2^-40, past where 1 + e rounds to 1 in f32 (2^-24)."""
    e = torch.cat([torch.logspace(-40, 0, 4001, base=2.0),
                   torch.tensor([2.0 ** -12, 2.0 ** -24, 1.0])]).float()
    want = torch.log1p(e.double())
    rel = ((_log1p(e).double() - want).abs() / want).max().item()
    assert rel <= 4e-7, rel
