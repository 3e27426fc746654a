"""The port's scan wrappers on the CPU (their plain versions) against the
JAX package: `selective_scan` vs `selective_scan_pallas` in interpret mode
at `tests/test_kernels.py`'s shapes, with and without h0, and vs
`selective_scan_ref` at a ragged shape the Pallas kernel refuses;
`ssm_scan` vs `ssm_scan_pallas`. The CUDA kernels run only on the card,
where chip_smoke.py holds them against the plain versions.
Tolerances are tests/test_kernels.py's: y 1e-4 (f32) and 3e-2 (bf16, one
rounding of the output), h_last 1e-3.

Numerical models of the kernels' designs in csrc/ssm_scan.cu, in numpy
float32 steps, against the JAX package:
- `exp2_fma`, the exponential on the FMA pipes, with the range reduction
  and the coefficients read from the .cu: relative error <= 2^-21 on
  [-126, 0], exactly 1 at 0 and 0 below -126;
- the selective scan's split of a channel's 16 states into NL = 16 / R
  lanes of R states, the first P of them through `exp2_fma`, the in-lane
  sums and the transposing butterfly across lanes, and the zero-padded
  ragged chunk: within 1e-4 of JAX's oracle and Pallas kernel, h_last
  too, and a state carried over two calls equal to one call bit for bit;
- the linear scan's chunked look-back, rolled forward from whichever
  inclusive state each look-back reaches first in an arbitrary order of
  completion: the same bits whatever the order, within 1e-5 of JAX.
"""
import re
from pathlib import Path

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
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    aligned_rows, selective_scan, ssm_scan)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
      / "csrc" / "ssm_scan.cu").read_text()

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
    autograd (on CUDA the selective scan differentiates through its
    backward kernel and `ssm_scan`, with none, raises under grad)."""
    _, (x, dt, a_log, b, c, d) = _sel_inputs((1, 8, 4, 4), "float32")
    x.requires_grad_()
    y, _ = selective_scan(x, dt, a_log, b, c, d)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# --------------------------------------------- models of the CUDA designs
F32 = np.float32


def _cu_const(name):
    """A `constexpr` number of csrc/ssm_scan.cu, as the kernel reads it."""
    m = re.search(rf"constexpr (?:float|int) {name} = ([0-9.e+-]+)f?;", CU)
    assert m, name
    return float(m.group(1))


def _fma(a, b, c):
    """fmaf in float32: the float32 product is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def exp2_fma(x):
    """csrc/ssm_scan.cu:exp2_fma step by step in float32."""
    rnd = F32(_cu_const("kExp2Round"))
    coef = [F32(_cu_const(f"kExp2C{k}")) for k in range(1, 6)]
    x = np.maximum(np.asarray(x, F32), F32(-127.0))
    t = (x + rnd).astype(F32)
    f = (x - (t - rnd).astype(F32)).astype(F32)
    p = _fma(coef[4], f, coef[3])
    for ck in (coef[2], coef[1], coef[0], F32(1.0)):
        p = _fma(p, f, ck)
    scale = (t.view(np.uint32) << np.uint32(23)).view(F32)
    r = (p * scale).astype(F32)
    return np.where(np.abs(r) < F32(2.0 ** -126), F32(0.0), r)   # mul.ftz


def test_exp2_fma_model_accuracy():
    assert "asm(\"mul.ftz.f32" in CU and "kExp2Round = 12583039.0f" in CU
    x = np.concatenate([np.linspace(-126, 0, 2_000_001, dtype=np.float64),
                        -np.arange(127.0), -np.arange(126.0) - 0.5,
                        -np.random.RandomState(0).rand(100_000) * 126])
    x = x.astype(F32)
    want = np.exp2(x.astype(np.float64))
    rel = np.abs(exp2_fma(x) - want) / want
    assert rel.max() <= 2.0 ** -21, np.log2(rel.max())
    assert exp2_fma(np.array([0.0, -0.0], F32)).tolist() == [1.0, 1.0]
    below = np.array([-126.0001, -126.5, -127, -150, -1e4, -1e30, -np.inf],
                     F32)
    assert (exp2_fma(below) == 0).all()


def _butterfly(v):
    """The transposing butterfly of csrc/ssm_scan.cu over NL lanes: v[q][i]
    is lane q's sum for step i of a group; returns lane q's v[0], the sum
    over lanes for step q, with the kernel's grouping of the adds."""
    nl = len(v)
    v = [list(lane) for lane in v]
    w = nl // 2
    while w >= 1:
        send = [[(v[q][i] if q & w else v[q][i + w]) for i in range(w)]
                for q in range(nl)]
        for q in range(nl):
            for i in range(w):
                keep = v[q][i + w] if q & w else v[q][i]
                v[q][i] = (keep + send[q ^ w][i]).astype(F32)
        w //= 2
    return [v[q][0] for q in range(nl)]


def sel_scan_model(x, dt, a_log, b, c, d, h0, r, p, chunk=32):
    """The selective-scan kernel's arithmetic in float32: x, dt [B,S,D],
    b, c [B,S,N], a_log [D,N], d [D], h0 [B,D,N] (numpy) -> y, h_last.
    Steps are walked in chunks of `chunk`, the last zero-padded; states
    padded to 16 carry zeros."""
    bsz, s, dd = x.shape
    n, npad = a_log.shape[1], 16
    nl = npad // r
    pad_s = -s % chunk

    def padded(t, width):
        out = np.zeros((bsz, s + pad_s, width), F32)
        out[:, :s, :t.shape[2]] = t
        return out

    x_, dt_ = padded(x, dd), padded(dt, dd)
    b_, c_ = padded(b, npad), padded(c, npad)
    a2 = np.zeros((dd, npad), F32)
    a2[:, :n] = (-np.exp(a_log.astype(F32))).astype(F32) * F32(
        _cu_const("kLog2e"))
    h = np.zeros((bsz, dd, npad), F32)
    h[:, :, :n] = h0
    y = np.zeros((bsz, s + pad_s, dd), F32)
    part = np.zeros((nl, s + pad_s, bsz, dd), F32)    # lane sums a step
    for t in range(s + pad_s):
        e_dt, e_x = dt_[:, t], x_[:, t]                  # [B,D]
        dtx = (e_dt * e_x).astype(F32)
        for q in range(nl):
            acc = None
            for k in range(r):
                nn = q * r + k
                arg = (e_dt * a2[None, :, nn]).astype(F32)
                da = exp2_fma(arg) if k < p else np.exp2(arg).astype(F32)
                u = (dtx * b_[:, t, None, nn]).astype(F32)
                h[:, :, nn] = _fma(da, h[:, :, nn], u)
                hc = h[:, :, nn]
                acc = ((hc * c_[:, t, None, nn]).astype(F32) if acc is None
                       else _fma(hc, c_[:, t, None, nn], acc))
            part[q, t] = acc
    for g in range(0, s + pad_s, nl):
        sums = _butterfly([[part[q, g + i] for i in range(nl)]
                           for q in range(nl)])
        for q in range(nl):
            y[:, g + q] = _fma(d[None, :], x_[:, g + q], sums[q])
    return y[:, :s], h[:, :, :n]


def _sel_np(shape, seed):
    _, targs = _sel_inputs(shape, "float32", seed=seed, with_h0=True)
    return [t.numpy() for t in targs]


@pytest.mark.parametrize("split", [(4, 1), (2, 0), (8, 3)])
@pytest.mark.parametrize("n", [5, 16])
def test_sel_scan_design_matches_jax_ragged(n, split):
    """S not a multiple of the 32-step chunk, D not of the 32-channel
    block: the model against JAX's oracle (the Pallas kernel asserts
    divisibility)."""
    args = _sel_np((2, 45, 37, n), seed=7)
    y, h = sel_scan_model(*args, *split)
    jy, jh = jref.selective_scan_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y, _f32(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h, _f32(jh), rtol=1e-4, atol=1e-4)


def test_sel_scan_design_matches_pallas():
    args = _sel_np((1, 64, 64, 16), seed=8)
    y, h = sel_scan_model(*args, 4, 1)
    jy, jh = selective_scan_pallas(*(jnp.asarray(a) for a in args),
                                   blk_t=32, blk_d=32, interpret=True)
    np.testing.assert_allclose(y, _f32(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h, _f32(jh), rtol=1e-4, atol=1e-4)


def test_sel_scan_design_carries_state_bit_for_bit():
    """The exp2 route is fixed by the state, the sum's grouping by the
    lane, and a padded step leaves h as it is: two calls split at a step
    that is a multiple of neither the chunk nor NL equal one call."""
    x, dt, a_log, b, c, d, h0 = _sel_np((1, 70, 8, 16), seed=9)
    y, h = sel_scan_model(x, dt, a_log, b, c, d, h0, 4, 1)
    k = 37
    y1, h1 = sel_scan_model(x[:, :k], dt[:, :k], a_log, b[:, :k], c[:, :k],
                            d, h0, 4, 1)
    y2, h2 = sel_scan_model(x[:, k:], dt[:, k:], a_log, b[:, k:], c[:, k:],
                            d, h1, 4, 1)
    np.testing.assert_array_equal(np.concatenate([y1, y2], 1), y)
    np.testing.assert_array_equal(h2, h)


def lin_scan_model(a, bx, h0, order, steps=64, chans=256):
    """The linear-scan kernel's look-back in float32: a, bx [B,S,D], h0
    [B,D]. `order` is a permutation of the tiles (time chunk slowest) in
    which they publish their inclusive states; a tile's look-back stops at
    the nearest predecessor published before it in that order, then rolls
    forward over the aggregates in time order, as the kernel does."""
    bsz, s, dd = a.shape
    n_k = -(-s // steps)
    pad = n_k * steps - s
    a_ = np.concatenate([a, np.ones((bsz, pad, dd), F32)], 1)
    b_ = np.concatenate([bx, np.zeros((bsz, pad, dd), F32)], 1)
    agg_a = np.ones((n_k, bsz, dd), F32)
    agg_b = np.zeros((n_k, bsz, dd), F32)
    for k in range(n_k):
        for j in range(steps):
            t = k * steps + j
            agg_a[k] = (agg_a[k] * a_[:, t]).astype(F32)
            agg_b[k] = _fma(a_[:, t], agg_b[k], b_[:, t])
    n_ct = -(-dd // chans)
    done_at = {tile: i for i, tile in enumerate(order)}
    incl = np.zeros((n_k, bsz, dd), F32)
    out = np.zeros_like(a_)
    for k in range(n_k):                   # every tile of chunk k
        for ct in range(n_ct):
            cols = slice(ct * chans, (ct + 1) * chans)
            if k == 0:
                h = h0[:, cols]
            else:
                j = k - 1                  # nearest inclusive before me
                while j > 0 and done_at[(j, ct)] > done_at[(k, ct)]:
                    j -= 1
                h = incl[j][:, cols]
                for m in range(j + 1, k):
                    h = _fma(agg_a[m][:, cols], h, agg_b[m][:, cols])
            incl[k][:, cols] = _fma(agg_a[k][:, cols], h, agg_b[k][:, cols])
            for jj in range(steps):
                t = k * steps + jj
                h = _fma(a_[:, t, cols], h, b_[:, t, cols])
                out[:, t, cols] = h
    return out[:, :s]


def _lin_np(shape, seed, with_h0):
    b, s, d = shape
    rng = np.random.RandomState(seed)
    a = (1 / (1 + np.exp(-rng.randn(b, s, d)))).astype(F32)
    bx = rng.randn(b, s, d).astype(F32)
    h0 = rng.randn(b, d).astype(F32) if with_h0 else np.zeros((b, d), F32)
    return a, bx, h0


def _orders(n_k, n_ct, seed):
    """Tile completion orders: in index order, reversed within each
    column, and shuffled."""
    tiles = [(k, ct) for k in range(n_k) for ct in range(n_ct)]
    rng = np.random.RandomState(seed)
    return [tiles, tiles[::-1],
            [tiles[i] for i in rng.permutation(len(tiles))]]


@pytest.mark.parametrize("with_h0", [False, True])
def test_lin_scan_lookback_matches_jax_ragged(with_h0):
    a, bx, h0 = _lin_np((2, 300, 300), seed=10, with_h0=with_h0)
    want = _f32(jref.ssm_scan_ref(jnp.asarray(a), jnp.asarray(bx),
                                  jnp.asarray(h0) if with_h0 else None))
    outs = [lin_scan_model(a, bx, h0, order)
            for order in _orders(5, 2, seed=11)]
    for got in outs:
        np.testing.assert_array_equal(got, outs[0])   # order-independent
    np.testing.assert_allclose(outs[0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_lin_scan_lookback_matches_pallas(with_h0):
    a, bx, h0 = _lin_np((1, 256, 512), seed=12, with_h0=with_h0)
    want = _f32(ssm_scan_pallas(jnp.asarray(a), jnp.asarray(bx),
                                jnp.asarray(h0) if with_h0 else None,
                                blk_t=64, blk_d=256, interpret=True))
    got = lin_scan_model(a, bx, h0, _orders(4, 2, seed=13)[2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_aligned_rows():
    """The selective scan's operands as its 16-byte cp.async pieces read
    them: aligned rows pass as they are, others are copied into padded
    rows with the same values."""
    base = torch.randn(2, 10, 4 + 2 * 16)
    b = base[..., 4:20]
    assert aligned_rows(b) is b             # 144-byte rows, 16-byte start
    odd = torch.randn(2, 10, 42)[..., 32:37]   # 168-byte rows, 128 + 20
    got = aligned_rows(odd)
    assert got.data_ptr() % 16 == 0 and got.stride(1) * 4 % 16 == 0
    assert got.stride(-1) == 1 and torch.equal(got, odd)
    half = torch.randn(1, 6, 5).to(torch.bfloat16)
    got = aligned_rows(half)
    assert got.stride(1) == 8 and torch.equal(got, half)
