"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package: `moe_gemm` vs `moe_gemm_pallas` in interpret mode and
`moe_gemm_ref`, and `attention_ref` vs the JAX oracle. The CUDA kernel
itself runs only on the card, where chip_smoke.py holds it against the
plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gemm import moe_gemm_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.moe_gemm import moe_gemm  # noqa: E402

MOE_SHAPES = [(4, 64, 128, 256), (8, 128, 256, 128), (3, 100, 96, 72)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(a, jdt, tdt):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", MOE_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_gemm_matches_jax(shape, dtype):
    e, c, d, f = shape
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(0)
    jx, tx = _both(rng.randn(e, c, d) * 0.3, jdt, tdt)
    jw, tw = _both(rng.randn(e, d, f) * 0.3, jdt, tdt)
    got = moe_gemm(tx, tw)
    assert got.dtype == tdt and got.shape == (e, c, f)
    pallas = moe_gemm_pallas(jx, jw, blk_c=64, blk_d=64, blk_f=64,
                             interpret=True)
    for want in (pallas, jref.moe_gemm_ref(jx, jw)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_moe_gemm_expert_isolation():
    """Each expert's output depends only on its own slice."""
    e, c, d, f = 4, 32, 64, 64
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(e, c, d).astype(np.float32))
    w = torch.from_numpy(rng.randn(e, d, f).astype(np.float32))
    base = moe_gemm(x, w)
    x2 = x.clone()
    x2[2] = 999.0
    pert = moe_gemm(x2, w)
    assert torch.equal(base[0], pert[0]) and torch.equal(base[3], pert[3])
    assert not torch.allclose(base[2], pert[2])


def test_moe_gemm_cpu_does_not_count_launches():
    before = moe_gemm.launches
    moe_gemm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    assert moe_gemm.launches == before


@pytest.mark.parametrize("x,w,err", [
    (torch.ones(2, 3, 4), torch.ones(3, 4, 5), ValueError),      # E differs
    (torch.ones(2, 3, 4), torch.ones(2, 5, 5), ValueError),      # d differs
    (torch.ones(3, 4), torch.ones(2, 4, 5), ValueError),         # rank
    (torch.ones(2, 0, 4), torch.ones(2, 4, 5), ValueError),      # empty
    (torch.ones(2, 3, 4), torch.ones(2, 4, 5, dtype=torch.bfloat16),
     TypeError),                                                  # mixed
    (torch.ones(2, 3, 4, dtype=torch.float16),
     torch.ones(2, 4, 5, dtype=torch.float16), TypeError),       # fp16
    (torch.ones(2, 4, 3).transpose(1, 2), torch.ones(2, 4, 5),
     ValueError),                                                 # strided
])
def test_moe_gemm_rejects(x, w, err):
    with pytest.raises(err):
        moe_gemm(x, w)


ATTN_CASES = [
    # (B, S, T, nq, nkv, kv_len, window, softcap)
    (2, 1, 16, 4, 2, 9, None, None),             # GQA 4:2, scalar kv_len
    (3, 1, 16, 4, 1, [1, 7, 16], None, None),    # GQA 4:1, [B] kv_len
    (3, 1, 16, 4, 2, [3, 12, 16], 4, None),      # decode window
    (2, 1, 16, 4, 1, [5, 16], None, 50.0),       # decode softcap
    (2, 8, 8, 4, 2, None, None, None),           # full, causal
    (2, 8, 12, 4, 1, None, 3, 30.0),             # S<T end-aligned, window
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_ref_matches_jax(case):
    b, s, t, nq, nkv, kv_len, window, softcap = case
    hd = 16
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(*shape).astype(np.float32) for shape in
               ((b, s, nq, hd), (b, t, nkv, hd), (b, t, nkv, hd)))
    causal = kv_len is None
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    tkv = None if kv_len is None else torch.tensor(kv_len)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, kv_len=jkv,
                              softcap=softcap)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, window=window,
                            kv_len=tkv, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # on the CPU the ops entry point is the plain op for every call
    routed = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, window=window,
                           kv_len=tkv, softcap=softcap)
    assert torch.equal(routed, got)
