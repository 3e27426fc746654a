"""The selective scan's backward on the CPU against the JAX package:
`ref.selective_scan_bwd_ref` (the plain version of the backward kernel in
csrc/ssm_scan.cu) against `jax.vjp` of `repro.kernels.ref.
selective_scan_ref`, which the JAX package differentiates in place of a
backward kernel, on the same numpy inputs: f32 and bf16, with and without
h0, with and without a cotangent for h_last, at a ragged shape and at
S=256, where the JAX oracle takes its chunked-remat branch. Then the
port's `selective_scan` under autograd on the CPU (autograd over the plain
forward) and its autograd Function (`_SelectiveScan`, which on the CPU
runs the plain forward and `selective_scan_bwd`'s plain version) against
`selective_scan_bwd_ref`, with B and C as column slices of one leaf.

Tolerances, on |got - want| <= tol * max(1, max |want|) for each
gradient: f32 1e-5 (the same f32 arithmetic, summed in other orders);
bf16 1e-2 (dx, ddt, dB and dC are rounded once to bf16 on each side, up
to 2^-8 apart; the f32 gradients from the same bf16 inputs keep 1e-5).
The CUDA kernels run only on the card, where chip_smoke.py holds them
against `selective_scan_bwd_ref`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ssm_scan as sscan  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    selective_scan_bwd_ref, selective_scan_ref)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    selective_scan, selective_scan_bwd)

GRADS = ("dx", "ddt", "da_log", "db", "dc", "dd", "dh0")
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, S, D, N): ragged (S and D off the kernel's 16-step segments and
# 64-channel blocks, N not a power of two) and S=256 (the JAX oracle's
# chunked remat)
SHAPES = {"ragged": (2, 45, 37, 5), "S=256": (1, 256, 24, 16)}


def _close(name, got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def _inputs(shape, dtype, seed=0):
    """numpy inputs (tests/test_kernels.py's scales), the cotangents and
    h0: x, dt, b, c, dy in `dtype`'s values; a_log, d, h0, dh in f32."""
    b, s, d, n = shape
    rng = np.random.RandomState(seed)
    act = {"x": rng.randn(b, s, d),
           "dt": np.logaddexp(rng.randn(b, s, d), 0) * 0.1,
           "b": rng.randn(b, s, n) * 0.5, "c": rng.randn(b, s, n) * 0.5,
           "dy": rng.randn(b, s, d)}
    act = {k: np.array(jnp.asarray(v, jnp.float32).astype(JDT[dtype])
                        .astype(jnp.float32)) for k, v in act.items()}
    f32 = {"a_log": np.log(np.arange(1, n + 1))[None].repeat(d, 0)
           + rng.randn(d, n) * 0.1,
           "d": rng.randn(d) * 0.5 + 1.0, "h0": rng.randn(b, d, n),
           "dh": rng.randn(b, d, n)}
    return {**act, **{k: v.astype(np.float32) for k, v in f32.items()}}


def _jax_vjp(v, dtype, with_h0, with_dh):
    """jax.vjp of the JAX oracle: the gradients in GRADS order (dh0 None
    without h0)."""
    jd = JDT[dtype]
    prim = [jnp.asarray(v["x"]).astype(jd), jnp.asarray(v["dt"]).astype(jd),
            jnp.asarray(v["a_log"]), jnp.asarray(v["b"]).astype(jd),
            jnp.asarray(v["c"]).astype(jd), jnp.asarray(v["d"])]
    if with_h0:
        prim.append(jnp.asarray(v["h0"]))
    (y, h_last), vjp = jax.vjp(jref.selective_scan_ref, *prim)
    dh = jnp.asarray(v["dh"]) if with_dh else jnp.zeros_like(h_last)
    grads = vjp((jnp.asarray(v["dy"]).astype(y.dtype), dh))
    return list(grads) + ([] if with_h0 else [None])


def _torch_args(v, dtype, with_h0):
    td = TDT[dtype]
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    return [t["x"].to(td), t["dt"].to(td), t["a_log"], t["b"].to(td),
            t["c"].to(td), t["d"], t["h0"] if with_h0 else None]


@pytest.mark.parametrize("with_dh", [False, True], ids=["no-dh", "dh"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_bwd_ref_matches_jax_vjp(dtype, shape, with_h0, with_dh):
    v = _inputs(SHAPES[shape], dtype)
    want = _jax_vjp(v, dtype, with_h0, with_dh)
    args = _torch_args(v, dtype, with_h0)
    dy = torch.from_numpy(v["dy"]).to(TDT[dtype])
    dh = torch.from_numpy(v["dh"]) if with_dh else None
    got = selective_scan_bwd_ref(*args, dy, dh)
    for name, g, w, t in zip(GRADS, got, want, args[:6] + [args[6]]):
        # dx, ddt, db, dc in their inputs' dtypes; da_log, dd, dh0 in f32
        want_dtype = t.dtype if name in ("dx", "ddt", "db", "dc") \
            else torch.float32
        assert g.dtype == want_dtype, (name, g.dtype)
        if w is None:                    # no h0: JAX has no dh0 to give
            continue
        tol = TOL[dtype] if g.dtype == torch.bfloat16 else TOL["float32"]
        _close(name, g, np.asarray(jnp.asarray(w).astype(jnp.float32)), tol)


@pytest.mark.parametrize("chunk", [1, 7, 16, 32, 128])
def test_bwd_ref_chunk_does_not_change_the_result(chunk):
    """The chunk only sets which states are kept and recomputed (16: the
    steps between the states the CUDA forward keeps for its backward)."""
    v = _inputs(SHAPES["ragged"], "float32", seed=1)
    args = _torch_args(v, "float32", True)
    dy, dh = torch.from_numpy(v["dy"]), torch.from_numpy(v["dh"])
    want = selective_scan_bwd_ref(*args, dy, dh, chunk=SHAPES["ragged"][1])
    got = selective_scan_bwd_ref(*args, dy, dh, chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        assert torch.equal(g, w), name


def _slices_of_one_leaf(v, dtype, with_h0):
    """Leaves x, dt, a_log, dbc, d (and h0) and the call's arguments, b
    and c being column slices of dbc as on the Mamba path."""
    args = _torch_args(v, dtype, with_h0)
    n = args[2].shape[1]
    dbc = torch.cat([torch.zeros_like(args[3][..., :3]), args[3], args[4]],
                    -1)
    leaves = [t.clone().requires_grad_() for t in
              (args[0], args[1], args[2], dbc, args[5])]
    if with_h0:
        leaves.append(args[6].clone().requires_grad_())
    x, dt, a_log, dbc, d = leaves[:5]
    call = [x, dt, a_log, dbc[..., 3:3 + n], dbc[..., 3 + n:], d,
            leaves[5] if with_h0 else None]
    return leaves, call


def _leaf_grads_from_bwd(v, dtype, with_h0, with_dh):
    """The leaves' gradients from `selective_scan_bwd_ref`: dB and dC
    placed in their columns of dbc."""
    args = _torch_args(v, dtype, with_h0)
    dy = torch.from_numpy(v["dy"]).to(TDT[dtype])
    dh = torch.from_numpy(v["dh"]) if with_dh else None
    dx, ddt, da_log, db, dc, dd, dh0 = selective_scan_bwd_ref(*args, dy, dh)
    ddbc = torch.cat([torch.zeros_like(db[..., :3]), db, dc], -1)
    return [dx, ddt, da_log, ddbc, dd] + ([dh0] if with_h0 else [])


@pytest.mark.parametrize("with_dh", [False, True], ids=["no-dh", "dh"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("how", ["wrapper", "function"])
def test_cpu_autograd_equals_bwd_ref(how, with_h0, with_dh):
    """`selective_scan` on the CPU (autograd over the plain forward) and
    the autograd Function the CUDA path takes (on the CPU: the plain
    forward and the plain backward) give the gradients of
    `selective_scan_bwd_ref`; h_last's gradient may be absent."""
    v = _inputs(SHAPES["ragged"], "float32", seed=2)
    leaves, call = _slices_of_one_leaf(v, "float32", with_h0)
    fn = selective_scan if how == "wrapper" else sscan._SelectiveScan.apply
    y, h_last = fn(*call)
    outs, cots = [y], [torch.from_numpy(v["dy"])]
    if with_dh:
        outs.append(h_last)
        cots.append(torch.from_numpy(v["dh"]))
    got = torch.autograd.grad(outs, leaves, cots)
    want = _leaf_grads_from_bwd(v, "float32", with_h0, with_dh)
    names = ("x", "dt", "a_log", "dbc", "d", "h0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == leaves[names.index(name)].dtype
        _close(name, g, w.numpy(), TOL["float32"])


def test_function_bf16_on_cpu_keeps_dtypes():
    v = _inputs(SHAPES["ragged"], "bfloat16", seed=3)
    leaves, call = _slices_of_one_leaf(v, "bfloat16", True)
    y, _ = sscan._SelectiveScan.apply(*call)
    got = torch.autograd.grad(y, leaves,
                              torch.from_numpy(v["dy"]).to(torch.bfloat16))
    want = _leaf_grads_from_bwd(v, "bfloat16", True, False)
    for leaf, g, w in zip(leaves, got, want):
        assert g.dtype == leaf.dtype
        _close("grad", g, w.float().numpy(),
               TOL["bfloat16" if leaf.dtype == torch.bfloat16
                   else "float32"])


def test_bwd_wrapper_routes_cpu_to_the_plain_version_and_checks():
    v = _inputs(SHAPES["ragged"], "float32", seed=4)
    args = _torch_args(v, "float32", True)
    dy, dh = torch.from_numpy(v["dy"]), torch.from_numpy(v["dh"])
    before = (selective_scan_bwd.launches, selective_scan_bwd.reduce_launches)
    got = selective_scan_bwd(*args, dy, dh)
    for name, g, w in zip(GRADS, got, selective_scan_bwd_ref(*args, dy, dh)):
        assert torch.equal(g, w), name
    assert (selective_scan_bwd.launches,
            selective_scan_bwd.reduce_launches) == before
    with pytest.raises(ValueError, match="dy"):
        selective_scan_bwd(*args, dy[:, 1:], dh)
    with pytest.raises(ValueError, match="dh_last"):
        selective_scan_bwd(*args, dy, dh[..., 1:])
    with pytest.raises(ValueError, match="cuda or cpu"):
        selective_scan_bwd(*(t.to("meta") for t in args), dy.to("meta"))


@pytest.mark.parametrize("dd,blocks", [(1, 1), (63, 1), (64, 1), (65, 2),
                                       (200, 4), (8192, 128), (8200, 129)])
def test_bwd_partials_cover_every_channel_block(dd, blocks):
    """The CUDA backward's scratch: dB and dC of each 64-channel block
    (the last one ragged), da_log's and dD's of each batch row."""
    bsz, s, n = 2, 45, 5
    n_bc, n_a, n_d = sscan.bwd_partials(bsz, s, dd, n, 64)
    assert n_bc == bsz * blocks * 2 * s * n
    assert (n_a, n_d) == (bsz * dd * n, bsz * dd)


def test_plain_forward_and_backward_agree_on_h_last():
    """The backward's recomputed states reach the forward's h_last: with
    dy = 0 and dh_last = e_k, dh0 is the Jacobian row of h_last[k]."""
    v = _inputs((1, 20, 3, 2), "float32", seed=5)
    args = _torch_args(v, "float32", True)
    h0 = args[6].clone().requires_grad_()
    _, h_last = selective_scan_ref(*args[:6], h0)
    e = torch.zeros_like(h_last)
    e[0, 1, 1] = 1.0
    (want,) = torch.autograd.grad(h_last, h0, e)
    got = selective_scan_bwd_ref(*args, torch.zeros_like(args[0]), e)[6]
    _close("dh0", got, want.numpy(), TOL["float32"])
