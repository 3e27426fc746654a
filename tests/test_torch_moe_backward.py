"""The `moe_gemm` backward and the MoE layer's gradients on the CPU, against
the JAX package: `moe_gemm_bwd_ref` (the plain version the dx and dw
kernels are held to on the card) against `jax.vjp` of JAX's
`moe_gemm_ref`; the wrappers on CPU tensors; the bf16 kernels' padding of
the backward's operands; and every gradient of the port's `MoE.forward`
(x, router, gate, up, down, shared experts) against `jax.grad` of
`apply_moe` on bridged weights, with tokens dropped and without. The
kernels themselves run only on the card, where `chip_smoke.py` holds them
against `moe_gemm_bwd_ref`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels.ref import (moe_gemm_bwd_ref,  # noqa: E402
                                     moe_gemm_dw_ref, moe_gemm_dx_ref)
from repro_torch.models.moe import capacity  # noqa: E402
from test_torch_kernels import MOE_SHAPES  # noqa: E402
from test_torch_model import _moe_case, _pair  # noqa: E402

# f32: the same f32 products summed in another order. bf16: both sides
# round an f32 sum to bf16 once, so they part by at most one bf16 ulp
# (2^-8 relative) where the sums straddle a rounding boundary.
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
GRAD_TOL = 1e-4                  # the MoE layer's f32 gradients


def _both(a, jdt, tdt):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _operands(shape, dtype, seed=0):
    """(JAX, torch) pairs of x [E,C,d], w [E,d,f] and dy [E,C,f]."""
    e, c, d, f = shape
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    return [_both(rng.randn(*shp) * 0.3, jdt, tdt)
            for shp in ((e, c, d), (e, d, f), (e, c, f))]


def _jax_grads(jx, jw, jdy):
    _, vjp = jax.vjp(jref.moe_gemm_ref, jx, jw)
    return vjp(jdy)


@pytest.mark.parametrize("shape", MOE_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_gemm_bwd_ref_matches_jax_vjp(shape, dtype):
    (jx, tx), (jw, tw), (jdy, tdy) = _operands(shape, dtype)
    want_dx, want_dw = _jax_grads(jx, jw, jdy)
    dx, dw = moe_gemm_bwd_ref(tx, tw, tdy)
    tol = DTYPES[dtype][2]
    assert dx.dtype == dw.dtype == tx.dtype
    assert dx.shape == tx.shape and dw.shape == tw.shape
    _close(dx, want_dx, tol)
    _close(dw, want_dw, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_gemm_autograd_on_cpu_matches_bwd_ref(dtype):
    """On the CPU `moe_gemm` is the plain version under autograd, and the
    wrappers of the two backward kernels are the plain backward; neither
    counts a launch."""
    (_, tx), (_, tw), (_, tdy) = _operands((3, 100, 93, 71), dtype, seed=1)
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    before = (mg.moe_gemm_bwd_dx.launches, mg.moe_gemm_bwd_dw.launches)
    gx, gw = torch.autograd.grad(mg.moe_gemm(x, w), (x, w), tdy)
    want_dx, want_dw = moe_gemm_bwd_ref(tx, tw, tdy)
    assert torch.equal(gx, want_dx) and torch.equal(gw, want_dw)
    assert torch.equal(mg.moe_gemm_bwd_dx(tdy, tw), want_dx)
    assert torch.equal(mg.moe_gemm_bwd_dw(tx, tdy), want_dw)
    assert (mg.moe_gemm_bwd_dx.launches,
            mg.moe_gemm_bwd_dw.launches) == before


@pytest.mark.parametrize("shape", [(3, 100, 93, 71), (2, 5, 8, 13)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_padded_moe_gemm_bwd_matches_jax(shape, dtype):
    """What the bf16 backward kernels compute: dx from dy and w with f (and
    w's d) zero-padded to multiples of 8, sliced back to d; dw from x and
    dy with d and f padded, sliced back to [d, f]."""
    (jx, tx), (jw, tw), (jdy, tdy) = _operands(shape, dtype, seed=2)
    want_dx, want_dw = _jax_grads(jx, jw, jdy)
    _, _, d, f = shape
    dyp, wp = mg._tma_operand(tdy, rows=False), mg._tma_operand(tw, rows=True)
    xp, dyp2 = mg._tma_operand(tx, rows=False), mg._tma_operand(tdy,
                                                               rows=False)
    assert all(t.shape[-1] % 8 == 0 for t in (dyp, wp, xp, dyp2))
    assert wp.shape[1] % 8 == 0
    dx = moe_gemm_dx_ref(dyp, wp)[..., :d]
    dw = moe_gemm_dw_ref(xp, dyp2)[:, :d, :f]
    tol = DTYPES[dtype][2]
    _close(dx, want_dx, tol)
    _close(dw, want_dw, tol)


@pytest.mark.parametrize("fn,a,b", [
    ("moe_gemm_bwd_dx", (2, 3, 5), (2, 4, 6)),     # dy's f != w's f
    ("moe_gemm_bwd_dx", (2, 3, 5), (3, 4, 5)),     # E differs
    ("moe_gemm_bwd_dw", (2, 3, 4), (2, 5, 6)),     # C differs
    ("moe_gemm_bwd_dw", (2, 3), (2, 3, 6)),        # rank
])
def test_moe_gemm_bwd_rejects(fn, a, b):
    with pytest.raises(ValueError):
        getattr(mg, fn)(torch.ones(a), torch.ones(b))


def test_moe_gemm_bwd_rejects_mixed_dtypes():
    with pytest.raises(TypeError):
        mg.moe_gemm_bwd_dw(torch.ones(2, 3, 4),
                           torch.ones(2, 3, 5, dtype=torch.bfloat16))


MOE_GRAD_CASES = {"drops": (1.25, True), "no drop": (16.0, False)}


@pytest.mark.parametrize("case", sorted(MOE_GRAD_CASES))
def test_moe_layer_gradients_match_jax(case):
    """d/d(x, every MoE parameter) of sum(y * r) + aux, f32, on bridged
    tiny qwen2-moe weights: with a crowd that overflows an expert's
    capacity (dropped slots get no gradient on either side) and with a
    capacity factor at which no token drops."""
    capacity_factor, crowd = MOE_GRAD_CASES[case]
    jm, jp, tm, tp = _pair(capacity_factor=capacity_factor)
    cfg = tm.cfg
    x = _moe_case(8, crowd)
    r = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], jp["layers"][0]["ffn"])
    if crowd:            # the case must really overflow a capacity
        logits = x.reshape(-1, x.shape[-1]) @ np.asarray(p0["router"])
        top = np.argsort(-logits[:, :cfg.num_experts], axis=1)[:, :2]
        assert np.bincount(top[:8].ravel()).max() > capacity(cfg, 8)

    def jloss(p, xj):
        y, aux = jax_moe.apply_moe(jm.cfg, p, xj)
        return jnp.sum(y * r) + aux

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        p0, jnp.asarray(x))
    layer = tp.layers[0].ffn
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = layer(xt)
    names, plist = zip(*layer.named_parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                (xt, *plist))
    _close(grads[0], want_x, GRAD_TOL)
    want = {"router": want_p["router"], "w_gate": want_p["w_gate"],
            "w_up": want_p["w_up"], "w_down": want_p["w_down"],
            **{f"shared.{k}": v for k, v in want_p["shared"].items()}}
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads[1:]):
        _close(g, want[name], GRAD_TOL)
