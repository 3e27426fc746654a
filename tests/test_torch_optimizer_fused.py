"""The training step's clip and AdamW (`train/optimizer.py`
`ClipAndAdamW`, kernels in `kernels/adamw.py`).

On the CPU: `ClipAndAdamW` is `clip_by_global_norm` then `adamw_update`,
bit for bit, and counts its leaves as plain; it matches the JAX
package's clip and AdamW (`repro/train/optimizer.py`) on the inputs whose
JAX results `data/adamw_jax.npz` keeps, and that file is what the JAX
package computes; leaves off the CPU that the kernels cannot take raise;
the fused pass's host tables cover every element of every leaf once, in
groups of `MAX_LEAVES`. On the card (marked `card`, skipped without
one): the two kernels against the plain loop, bit for bit given the same
scale, over empty leaves, odd sizes, misaligned views and strided
gradients; against the JAX results of `data/adamw_jax.npz`; the norm's
determinism; more leaves than a launch takes, in grouped launches; the
raise; the benchmark's training cell's whole leaf list on the fused
pass.

`python tests/test_torch_optimizer_fused.py` writes `data/adamw_jax.npz`
anew with the JAX package on the CPU."""
from __future__ import annotations

import bisect
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from repro_torch.kernels import adamw as fused
from repro_torch.train.optimizer import (ClipAndAdamW, OptConfig,
                                         adamw_update, clip_by_global_norm,
                                         global_norm, init_opt_state)

SIZES = (0, 1, 7, 8, 4099, 2**20 + 3)
BF16, F32 = torch.bfloat16, torch.float32
PAIRS = {"f32-f32": (F32, F32), "bf16-bf16": (BF16, BF16),
         "bf16-f32": (BF16, F32)}
# "own": tensors of their own; "same": p, g, m, v views at one odd offset
# (vectors after a head); "p": p alone such a view (the scalar loop)
KINDS = ("own", "same", "p")
CLIP = {"clip-active": 1.0, "clip-inactive": 1e6}
CFG = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)


class _Leaves(nn.Module):
    def __init__(self, tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))


def _view(n: int, dtype, dev, offset: int) -> torch.Tensor:
    """n zeros, `offset` elements into a buffer of their own."""
    return torch.zeros(n + offset, dtype=dtype, device=dev)[offset:]


class _Case:
    """Leaves of every size of `sizes` and kind of `kinds`, in `pdt`, with
    gradients in `gdt`, on `dev`; `grads(scale)` draws a step's gradients
    into tensors laid out as the kind says."""

    def __init__(self, pdt, gdt, dev, sizes=SIZES, kinds=KINDS, seed=0):
        self.gdt, self.dev = gdt, dev
        self.gen = torch.Generator().manual_seed(seed)
        self.layout = {}
        tensors = {}
        for i, n in enumerate(sizes):
            for kind in kinds:
                name = f"w{i}_{kind}"
                off = 3 + 2 * i if kind != "own" else 0
                p = _view(n, pdt, dev, off)
                p.copy_(torch.randn(n, generator=self.gen))
                tensors[name] = p
                self.layout[name] = (n, off if kind == "same" else 0)
        self.params = _Leaves(tensors)
        self.opt = init_opt_state(self.params)
        for name, (n, off) in self.layout.items():
            if off:
                for k in ("m", "v"):
                    self.opt[k][name] = _view(n, F32, dev, off)

    def grads(self, scale: float):
        out = {}
        for name, (n, off) in self.layout.items():
            g = _view(n, self.gdt, self.dev, off)
            g.copy_(torch.randn(n, generator=self.gen) * scale)
            out[name] = g
        return out

    def plain_copy(self):
        """The same values in tensors of their own: params and state."""
        params = _Leaves({n: p.detach().clone()
                          for n, p in self.params.named_parameters()})
        opt = {"m": {n: t.clone() for n, t in self.opt["m"].items()},
               "v": {n: t.clone() for n, t in self.opt["v"].items()},
               "step": self.opt["step"].clone()}
        return params, opt


def _equal_state(pa, oa, pb, ob) -> None:
    qs = dict(pb.named_parameters())
    for name, p in pa.named_parameters():
        assert torch.equal(p, qs[name]), name
        assert torch.equal(oa["m"][name], ob["m"][name]), name
        assert torch.equal(oa["v"][name], ob["v"][name]), name
    assert torch.equal(oa["step"], ob["step"])


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("clip", CLIP, ids=str)
@pytest.mark.parametrize("pair", PAIRS, ids=str)
def test_clip_and_adamw_on_the_cpu_is_the_plain_loop(pair, clip):
    """Three steps of `ClipAndAdamW` against `clip_by_global_norm` then
    `adamw_update` on copies: p, m, v, step, lr and the norm equal."""
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                    clip_norm=CLIP[clip])
    case = _Case(*PAIRS[pair], "cpu", sizes=SIZES[:5])
    params_b, opt_b = case.plain_copy()
    step = ClipAndAdamW(cfg)
    for _ in range(3):
        grads = case.grads(0.5)
        _, _, lr, gnorm = step(grads, case.opt, case.params)
        clipped, norm_b = clip_by_global_norm(grads, cfg.clip_norm)
        _, _, lr_b = adamw_update(cfg, clipped, opt_b, params_b)
        assert torch.equal(lr, lr_b) and torch.equal(gnorm, norm_b)
        assert (float(gnorm) > cfg.clip_norm) == (clip == "clip-active")
    _equal_state(case.params, case.opt, params_b, opt_b)


def test_the_cpu_counts_every_leaf_as_plain():
    case = _Case(BF16, F32, "cpu", sizes=SIZES[:3])
    step = ClipAndAdamW(CFG)
    for _ in range(2):
        step(case.grads(1.0), case.opt, case.params)
    n = len(list(case.params.parameters()))
    assert (step.fused_leaves.total, step.plain_leaves.total) == (0, 2 * n)
    assert fused.on_cpu([(p, p, p, p) for p in case.params.parameters()],
                        case.opt["step"])


def _meta(n=12, dtype=F32):
    return torch.zeros(n, dtype=dtype, device="meta")


# leaves (p, g, m, v) off the CPU that the kernels cannot take, and the
# words of the error that names why
REFUSED = {
    "fp16-params": (lambda: (_meta(dtype=torch.float16), _meta(), _meta(),
                             _meta()), "bf16 or f32"),
    "fp16-grads": (lambda: (_meta(), _meta(dtype=torch.float16), _meta(),
                            _meta()), "bf16 or f32"),
    "bf16-state": (lambda: (_meta(), _meta(), _meta(dtype=BF16), _meta()),
                   "where the kernels take f32"),
    "shapes": (lambda: (_meta(), _meta(11), _meta(), _meta()), "shapes"),
    "strided-params": (lambda: (_meta(24)[::2], _meta(), _meta(), _meta()),
                       "contiguous"),
    "strided-state": (lambda: (_meta(), _meta(), _meta(), _meta(24)[::2]),
                      "contiguous"),
    "two-devices": (lambda: (_meta(), torch.zeros(12), _meta(), _meta()),
                    "more than one device"),
    "not-cuda": (lambda: (_meta(), _meta(), _meta(), _meta()),
                 "one CUDA device"),
}


@pytest.mark.parametrize("case", REFUSED, ids=str)
def test_leaves_the_kernels_cannot_take_raise_off_the_cpu(case):
    """Leaves not all on the CPU go to the kernels or raise: no plain
    loop runs on a device, and nothing is updated or counted."""
    make, words = REFUSED[case]
    p, g, m, v = make()
    params = _Leaves({"w": p})
    opt = {"m": {"w": m}, "v": {"w": v},
           "step": torch.zeros((), dtype=torch.int32, device="meta")}
    assert not fused.on_cpu([(p, g, m, v)], opt["step"])
    step = ClipAndAdamW(CFG)
    with pytest.raises(ValueError, match=words):
        step({"w": g}, opt, params)
    assert (step.fused_leaves.total, step.plain_leaves.total) == (0, 0)


def _chunks(rows: list, n_chunks: int) -> list:
    """(leaf, start, length) of each chunk as the kernels find it: the
    last leaf whose first chunk is at most c, `CHUNK` elements a chunk."""
    out = []
    firsts = [r[4] for r in rows]
    for c in range(n_chunks):
        leaf = bisect.bisect_right(firsts, c) - 1
        start = (c - firsts[leaf]) * fused.CHUNK
        out.append((leaf, start, min(fused.CHUNK, rows[leaf][3] - start)))
    return out


def _table_rows(plan) -> list:
    """Each table's rows, in order, and the chunks the kernels find in
    it, with the leaf's index in the whole list."""
    out, base = [], 0
    for rows, n_chunks in plan.tables:
        rows = rows.tolist()
        out.append((rows, [(base + leaf, start, length) for leaf, start,
                           length in _chunks(rows, n_chunks)]))
        base += len(rows)
    return out


TABLES = {
    "sizes-f32": dict(pdt=F32, gdt=F32, kinds=("own",)),
    "sizes-bf16": dict(pdt=BF16, gdt=BF16, kinds=("own",)),
    "views-2-byte-offsets": dict(pdt=BF16, gdt=BF16, kinds=("same", "p")),
    "mixed-dtypes": dict(pdt=BF16, gdt=F32, kinds=KINDS, mix=True),
    "f32-params-bf16-grads": dict(pdt=F32, gdt=BF16, kinds=KINDS),
    "empty-leaves": dict(pdt=BF16, gdt=BF16, sizes=(0, 7, 0, 4099, 0),
                         kinds=("own",)),
    "more-leaves-than-a-launch": dict(
        pdt=BF16, gdt=F32, kinds=("own",),
        sizes=(3,) * fused.MAX_LEAVES + (40_000, 5, 2**20 + 3)),
}


@pytest.mark.parametrize("case", TABLES, ids=str)
def test_the_tables_cover_every_element_of_every_leaf_once(case):
    """The leaf rows, in tables of up to `MAX_LEAVES` (one a launch),
    point at each leaf's p, m and v with its size and dtypes; the chunks
    the kernels find from each table's first chunks, at most `CHUNK`
    long, cover each element of each leaf exactly once."""
    kw = dict(TABLES[case])
    mix = kw.pop("mix", False)
    c = _Case(dev="cpu", **kw)
    leaves = [(p, torch.empty(0, dtype=c.gdt), c.opt["m"][n], c.opt["v"][n])
              for n, p in c.params.named_parameters()]
    if mix:         # every other leaf an f32 parameter with a bf16 gradient
        leaves = [(p.float(), torch.empty(0, dtype=BF16), m, v)
                  if i % 2 else (p, g, m, v)
                  for i, (p, g, m, v) in enumerate(leaves)]
    plan = fused.make_plan(leaves, grid=5)
    groups = -(-len(leaves) // fused.MAX_LEAVES)
    assert plan.partials.numel() == 5 and plan.ticket.tolist() == [0]
    assert len(plan.tables) == plan.sums.numel() == groups
    codes = {BF16: 0, F32: 1}
    tables = _table_rows(plan)
    rows = [row for rows, _ in tables for row in rows]
    assert [len(r) for r, _ in tables] == [
        min(fused.MAX_LEAVES, len(leaves) - k * fused.MAX_LEAVES)
        for k in range(groups)]
    for (p, g, m, v), row in zip(leaves, rows, strict=True):
        assert row[:4] + row[5:] == [p.data_ptr(), m.data_ptr(), v.data_ptr(),
                                     p.numel(),
                                     codes[p.dtype] | codes[g.dtype] << 32]
    cover = [torch.zeros(p.numel(), dtype=torch.int32)
             for p, _, _, _ in leaves]
    for _, chunks in tables:
        for leaf, start, length in chunks:
            assert 0 < length <= fused.CHUNK
            cover[leaf][start:start + length] += 1
    for cv in cover:
        assert torch.equal(cv, torch.ones_like(cv))


# ------------------------------------------------------ the JAX results
FIXTURE = Path(__file__).parent / "data" / "adamw_jax.npz"
JAX_SIZES = (1, 7, 130, 1029)
JAX_STEPS = 3
# test_torch_train.py's test_adamw_matches_jax: p to 1e-6 in f32 and one
# ulp in bf16, m and v to 1e-5 (atol 1e-7), lr to 1e-6; the norm to 1e-5
P_TOL = {F32: 1e-6, BF16: 8e-3}


def _jax_inputs(pair: str, clip: str) -> dict:
    """Seeded p, m, v and JAX_STEPS steps of gradients, leaf by leaf, as
    f32 numpy arrays that hold values of the case's dtypes exactly."""
    pdt, gdt = PAIRS[pair]
    rng = np.random.RandomState(sorted(PAIRS).index(pair) * 2
                                + sorted(CLIP).index(clip))

    def draw(scale, dtype):
        return [torch.from_numpy(rng.randn(n).astype(np.float32) * scale)
                .to(dtype).float().numpy() for n in JAX_SIZES]
    return {"p": draw(1.0, pdt), "m": draw(1e-2, F32),
            "v": [np.abs(x) for x in draw(1e-3, F32)],
            "g": [draw(0.5, gdt) for _ in range(JAX_STEPS)]}


def _jax_results(pair: str, clip: str) -> dict:
    """The JAX package's clip_by_global_norm then adamw_update, on the CPU,
    JAX_STEPS steps from `_jax_inputs`: the final p, m, v (each leaf's, one
    after another, in f32), and each step's norm and lr."""
    import jax.numpy as jnp

    from repro.train import optimizer as jopt
    pdt, gdt = (jnp.float32 if t == F32 else jnp.bfloat16
                for t in PAIRS[pair])
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                    clip_norm=CLIP[clip])
    x = _jax_inputs(pair, clip)
    names = [f"w{i}" for i in range(len(JAX_SIZES))]
    params = {n: jnp.asarray(a).astype(pdt) for n, a in zip(names, x["p"])}
    opt = {"m": {n: jnp.asarray(a) for n, a in zip(names, x["m"])},
           "v": {n: jnp.asarray(a) for n, a in zip(names, x["v"])},
           "step": jnp.zeros((), jnp.int32)}
    norms, lrs = [], []
    for gs in x["g"]:
        grads = {n: jnp.asarray(a).astype(gdt) for n, a in zip(names, gs)}
        clipped, gnorm = jopt.clip_by_global_norm(grads, cfg.clip_norm)
        params, opt, lr = jopt.adamw_update(cfg, clipped, opt, params)
        norms.append(float(gnorm))
        lrs.append(float(lr))
    flat = {k: np.concatenate([np.asarray(t[n], np.float32) for n in names])
            for k, t in (("p", params), ("m", opt["m"]), ("v", opt["v"]))}
    return dict(flat, norm=np.array(norms, np.float32),
                lr=np.array(lrs, np.float32))


def _fixture(pair: str, clip: str) -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[f"{pair}.{clip}.{k}"] for k in ("p", "m", "v", "norm",
                                                      "lr")}


def _run_port(pair: str, clip: str, dev: str) -> dict:
    """`ClipAndAdamW` over `_jax_inputs` on `dev`: p, m, v views at an odd
    offset into buffers of their own; the same keys as `_jax_results`."""
    pdt, gdt = PAIRS[pair]
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                    clip_norm=CLIP[clip])
    x = _jax_inputs(pair, clip)

    def put(a, dtype):
        t = _view(a.size, dtype, dev, 1)
        t.copy_(torch.from_numpy(a))
        return t
    names = [f"w{i}" for i in range(len(JAX_SIZES))]
    params = _Leaves({n: put(a, pdt) for n, a in zip(names, x["p"])})
    opt = {"m": {n: put(a, F32) for n, a in zip(names, x["m"])},
           "v": {n: put(a, F32) for n, a in zip(names, x["v"])},
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step = ClipAndAdamW(cfg)
    norms, lrs = [], []
    for gs in x["g"]:
        _, _, lr, gnorm = step({n: put(a, gdt) for n, a in zip(names, gs)},
                               opt, params)
        norms.append(float(gnorm))
        lrs.append(float(lr))
    path = "fused" if dev == "cuda" else "plain"
    assert getattr(step, f"{path}_leaves").total == JAX_STEPS * len(names)
    flat = {k: torch.cat([t[n].detach().float().cpu() for n in names])
            .numpy() for k, t in (("p", dict(params.named_parameters())),
                                  ("m", opt["m"]), ("v", opt["v"]))}
    return dict(flat, norm=np.array(norms, np.float32),
                lr=np.array(lrs, np.float32))


def _close_to_jax(got: dict, want: dict, pdt) -> None:
    tol = P_TOL[pdt]
    np.testing.assert_allclose(got["p"], want["p"], rtol=tol, atol=tol)
    for k in ("m", "v"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-5)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)


@pytest.mark.parametrize("clip", CLIP, ids=str)
@pytest.mark.parametrize("pair", PAIRS, ids=str)
def test_the_jax_fixture_is_the_jax_optimizer_and_the_cpu_matches_it(
        pair, clip):
    """`data/adamw_jax.npz` holds what the JAX package's clip and AdamW
    compute (run here again), and `ClipAndAdamW` on the CPU matches it
    to test_adamw_matches_jax's tolerances."""
    pytest.importorskip("jax")
    want = _fixture(pair, clip)
    _close_to_jax(_jax_results(pair, clip), want, PAIRS[pair][0])
    got = _run_port(pair, clip, "cpu")
    _close_to_jax(got, want, PAIRS[pair][0])
    assert (want["norm"] > CLIP[clip]).all() == (clip == "clip-active")


# ------------------------------------------------------------------ card
def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _plain_step(cfg, grads, gnorm, opt, params):
    """`clip_by_global_norm`'s clip with the scale the fused norm gives,
    then `adamw_update`."""
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    clipped = {n: g * scale.to(g.dtype) for n, g in grads.items()}
    return adamw_update(cfg, clipped, opt, params)


@pytest.mark.card
@pytest.mark.parametrize("clip", CLIP, ids=str)
@pytest.mark.parametrize("pair", PAIRS, ids=str)
def test_fused_equals_plain_on_the_card(pair, clip):
    """Three steps through the fused pass against the plain loop given
    the fused norm's scale: p, m, v and lr bit-equal, over empty leaves,
    odd sizes, aligned leaves, views at one odd offset and p-only views;
    the norm within 1e-5 of the plain one, all leaves on the fused
    pass."""
    _card()
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                    clip_norm=CLIP[clip])
    case = _Case(*PAIRS[pair], "cuda")
    params_b, opt_b = case.plain_copy()
    step = ClipAndAdamW(cfg)
    for _ in range(3):
        grads = case.grads(0.5)
        _, _, lr, gnorm = step(grads, case.opt, case.params)
        _, _, lr_b = _plain_step(cfg, grads, gnorm, opt_b, params_b)
        assert torch.equal(lr, lr_b)
        ref = global_norm(grads)
        assert abs(float(gnorm) - float(ref)) <= 1e-5 * float(ref)
        assert (float(gnorm) > cfg.clip_norm) == (clip == "clip-active")
    torch.cuda.synchronize()
    _equal_state(case.params, case.opt, params_b, opt_b)
    n = len(list(case.params.parameters()))
    assert (step.fused_leaves.total, step.plain_leaves.total) == (3 * n, 0)


@pytest.mark.card
@pytest.mark.parametrize("pair", PAIRS, ids=str)
def test_fused_norm_is_deterministic_on_the_card(pair):
    """The norm of ~20 M gradient elements: bit-identical over two
    launches, within 1e-5 of the plain norm, and its scale the plain
    clip's of that norm."""
    _card()
    case = _Case(*PAIRS[pair], "cuda", sizes=SIZES + (19_000_001,))
    grads = case.grads(1.0)
    leaves = [(p, grads[n], case.opt["m"][n], case.opt["v"][n])
              for n, p in case.params.named_parameters()]
    fused.check(leaves, case.opt["step"])
    plan = fused.make_plan(leaves, fused.grid_blocks(0))
    gs = [g for _, g, _, _ in leaves]
    n0 = fused.norm.launches
    first = fused.norm(plan, gs, 1.0)
    second = fused.norm(plan, gs, 1.0)
    assert torch.equal(first, second) and fused.norm.launches - n0 == 2
    assert plan.ticket.item() == 0
    ref = global_norm(grads)
    assert abs(float(first[0]) - float(ref)) <= 1e-5 * float(ref)
    scale = torch.clamp(1.0 / (first[0] + 1e-9), max=1.0)
    assert torch.equal(first[1], scale)


@pytest.mark.card
@pytest.mark.parametrize("clip", CLIP, ids=str)
@pytest.mark.parametrize("pair", PAIRS, ids=str)
def test_fused_matches_jax_on_the_card(pair, clip):
    """Three `ClipAndAdamW` steps on the card from the inputs of
    `data/adamw_jax.npz`: p, m, v, the norm and lr match the JAX
    package's clip and AdamW (computed on the CPU into that file) to
    test_adamw_matches_jax's tolerances, all leaves on the fused pass."""
    _card()
    _close_to_jax(_run_port(pair, clip, "cuda"), _fixture(pair, clip),
                  PAIRS[pair][0])


@pytest.mark.card
def test_more_leaves_than_a_launch_take_grouped_launches_on_the_card():
    """`MAX_LEAVES` + 3 leaves, one of them strided gradients: two
    launches of each kernel a step, one sum a group; p, m and v bit-equal
    to the plain loop given the same scale, the norm within 1e-5 of the
    plain one."""
    _card()
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    case = _Case(BF16, F32, "cuda", kinds=("own",),
                 sizes=(3,) * fused.MAX_LEAVES + (40_000, 5, 2**20 + 3))
    params_b, opt_b = case.plain_copy()
    step = ClipAndAdamW(cfg)
    n0 = (fused.norm.launches, fused.update.launches)
    for _ in range(2):
        grads = case.grads(0.5)
        grads["w0_own"] = torch.stack([grads["w0_own"]] * 2, 1)[:, 0]
        assert not grads["w0_own"].is_contiguous()
        _, _, lr, gnorm = step(grads, case.opt, case.params)
        _, _, lr_b = _plain_step(cfg, grads, gnorm, opt_b, params_b)
        assert torch.equal(lr, lr_b)
        ref = global_norm(grads)
        assert abs(float(gnorm) - float(ref)) <= 1e-5 * float(ref)
        assert float(gnorm) > cfg.clip_norm
    torch.cuda.synchronize()
    _equal_state(case.params, case.opt, params_b, opt_b)
    assert (fused.norm.launches - n0[0], fused.update.launches - n0[1]) \
        == (4, 4)
    n = fused.MAX_LEAVES + 3
    assert (step.fused_leaves.total, step.plain_leaves.total) == (2 * n, 0)
    assert len(step._plan.tables) == 2


@pytest.mark.card
@pytest.mark.parametrize("case", ("fp16-params", "bf16-state",
                                  "strided-params"), ids=str)
def test_leaves_the_kernels_cannot_take_raise_on_the_card(case):
    """On the card, as off it: no plain loop, a ValueError."""
    _card()
    make, words = REFUSED[case]
    p, g, m, v = (torch.empty_like(t, device="cuda") if t.is_contiguous()
                  else torch.empty(2 * t.shape[0], dtype=t.dtype,
                                   device="cuda")[::2] for t in make())
    params = _Leaves({"w": p})
    opt = {"m": {"w": m}, "v": {"w": v},
           "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = ClipAndAdamW(CFG)
    with pytest.raises(ValueError, match=words):
        step({"w": g}, opt, params)
    assert (step.fused_leaves.total, step.plain_leaves.total) == (0, 0)


@pytest.mark.card
def test_the_training_cells_leaves_take_the_fused_pass_on_the_card():
    """The benchmark's qwen2-moe-a2.7b leaves at full size (views of one
    buffer a dtype, as the cell makes them): one step updates all 67 on
    the fused pass and none on the plain loop."""
    _card()
    from port_bench import harness
    from port_bench.arch import Arch
    from port_bench.weights import make_weights
    a = Arch.load("qwen2-moe-a2.7b")
    dev = torch.device("cuda")
    _, params = harness.load_program(a, make_weights(a, 2**31 + 11, dev),
                                     dev, train=True)
    opt = init_opt_state(params)
    grads = {n: torch.randn(p.shape, dtype=p.dtype, device=dev) * 1e-4
             for n, p in params.named_parameters()}
    step = ClipAndAdamW(CFG)
    before = params.get_parameter("embed.embedding")[:4].clone()
    _, _, _, gnorm = step(grads, opt, params)
    torch.cuda.synchronize()
    assert (step.fused_leaves.total, step.plain_leaves.total) == (67, 0)
    assert torch.isfinite(gnorm)
    after = params.get_parameter("embed.embedding")[:4]
    assert not torch.equal(before, after) and torch.isfinite(after).all()


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **{
        f"{pair}.{clip}.{k}": a for pair in PAIRS for clip in CLIP
        for k, a in _jax_results(pair, clip).items()})
    print(f"wrote {FIXTURE}")
