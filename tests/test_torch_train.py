"""The port's training substrate on the CPU, against the JAX package where
they share a contract: port versions of tests/test_train_substrate.py's
optimizer, checkpoint, fault, data and end-to-end tests; the microbatch
order; the loss and every parameter gradient, and one train step on
bridged f32 params and optimizer state, against JAX's on the same numpy
batch, for the dense arch, the MoE archs (`MOE_ARCHS`) and Jamba with its
whole 8-position period (Mamba, attention and MoE layers: the selective
scan's gradients on the CPU are autograd's over its plain version, which
`tests/test_torch_ssm_backward.py` holds to the backward kernel's plain
version)."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the CPU
torch.set_num_threads(1)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import tiny_config as jax_tiny_config  # noqa: E402
from repro.models.registry import get_model as jax_get_model  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.train.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.convert import (jax_grads, load_jax_opt_state,  # noqa: E402
                                 load_jax_params)
from repro_torch.core.dispatcher import FunctionalityDispatcher  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.data import DataConfig, Prefetcher, SyntheticLM  # noqa: E402,E501
from repro_torch.train.fault import (ElasticPlanner,  # noqa: E402
                                     HeartbeatMonitor)
from repro_torch.train.optimizer import (OptConfig, adamw_update,  # noqa: E402
                                         clip_by_global_norm, init_opt_state,
                                         schedule)
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_loss_fn, make_train_step,
                                          microbatch_schedule)

ARCH = "qwen2-0.5b"
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_ARCHS = [MOE_ARCH, "qwen3-moe-235b-a22b"]
JAMBA = "jamba-v0.1-52b"


class _Params(nn.Module):
    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


# ---------------------------------------------------------------- optimizer
def test_adamw_converges_quadratic():
    cfg = OptConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                    weight_decay=0.0, clip_norm=1e9)
    params = _Params(w=torch.tensor([3.0, -2.0]))
    opt = init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params.w.detach()}          # d/dw ||w||^2
        adamw_update(cfg, grads, opt, params)
    assert float(params.w.detach().abs().max()) < 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(dtype):
    """Three steps from the same values: f32 math from the parameter's
    dtype, one cast back, weight decay inside the step."""
    cfg = OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    rng = np.random.RandomState(0)
    p0 = jnp.asarray(rng.randn(64), jnp.float32).astype(dtype)
    jp = {"w": p0}
    jo = jopt.init_opt_state(jp)
    params = _Params(w=torch.from_numpy(np.array(p0.astype(jnp.float32)))
                     .to(getattr(torch, dtype)))
    opt = init_opt_state(params)
    for _ in range(3):
        g = rng.randn(64).astype(np.float32)
        jp, jo, jlr = jopt.adamw_update(cfg, {"w": jnp.asarray(g)}, jo, jp)
        _, _, lr = adamw_update(cfg, {"w": torch.from_numpy(g)}, opt, params)
    assert float(lr) == pytest.approx(float(jlr), rel=1e-6)
    assert int(opt["step"]) == int(jo["step"]) == 3
    tol = 1e-6 if dtype == "float32" else 8e-3     # one bf16 ulp
    np.testing.assert_allclose(params.w.detach().float().numpy(),
                               np.asarray(jp["w"], np.float32),
                               rtol=tol, atol=tol)
    for key in ("m", "v"):
        np.testing.assert_allclose(opt[key]["w"].numpy(),
                                   np.asarray(jo[key]["w"]), rtol=1e-5,
                                   atol=1e-7)


def test_schedule_warmup_and_decay():
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(schedule(cfg, torch.tensor(5))) < cfg.peak_lr
    peak = float(schedule(cfg, torch.tensor(10)))
    end = float(schedule(cfg, torch.tensor(100)))
    assert peak == pytest.approx(cfg.peak_lr, rel=1e-3)
    assert end == pytest.approx(cfg.peak_lr * cfg.min_lr_frac, rel=1e-2)
    steps = np.arange(0, 120)
    np.testing.assert_allclose(
        schedule(cfg, torch.from_numpy(steps)).numpy(),
        np.asarray(jopt.schedule(cfg, jnp.asarray(steps))), rtol=1e-6)


def test_clip_global_norm():
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-3)


# -------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    cm.save(3, tree, blocking=True)
    got = cm.restore(tree)
    assert got is not None
    step, t2 = got
    assert step == 3
    assert torch.equal(t2["a"], tree["a"])
    assert t2["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(t2["b"]["c"], tree["b"]["c"])
    assert t2["step"].dtype == torch.int32 and int(t2["step"]) == 7


def test_checkpoint_save_snapshots_before_enqueue(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    w = torch.ones(4)
    cm.save(1, {"w": w})                       # enqueued, not yet on disk
    w.add_(5.0)                                # a later in-place update
    cm.flush()
    assert torch.equal(cm.restore({"w": w})[1]["w"], torch.ones(4))


def test_checkpoint_survives_corruption(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    tree = {"w": torch.ones((4, 4))}
    cm.save(1, tree, blocking=True)
    cm.save(2, {"w": torch.ones((4, 4)) * 2}, blocking=True)
    # corrupt the newest checkpoint (torn write simulation)
    with open(tmp_path / "step-2" / "leaf0.npy", "wb") as f:
        f.write(b"garbage")
    got = cm.restore(tree)
    assert got is not None and got[0] == 1    # falls back to older valid
    assert torch.equal(got[1]["w"], torch.ones((4, 4)))


def test_checkpoint_async_via_dispatcher(tmp_path):
    disp = FunctionalityDispatcher()
    cm = CheckpointManager(str(tmp_path), dispatcher=disp)
    cm.save(5, {"w": torch.zeros(2)})         # enqueued, not yet on disk
    assert cm.steps() == []
    disp.notify_idle(0)                        # idle thread does the I/O
    assert cm.steps() == [5]


def test_checkpoint_keeps_last_k(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, {"w": torch.zeros(2)}, blocking=True)
    assert cm.steps() == [3, 4]


# ------------------------------------------------------------------ fault
def test_heartbeat_dead_and_straggler():
    t = [0.0]
    hb = HeartbeatMonitor(["h0", "h1", "h2"], timeout=10.0,
                          straggler_factor=2.0, clock=lambda: t[0])
    for h in ("h0", "h1", "h2"):
        hb.beat(h, 1, 1.0)
    t[0] = 5.0
    hb.beat("h0", 2, 1.0)
    hb.beat("h1", 2, 5.0)                      # straggler: 5x median
    assert hb.stragglers() == ["h1"]
    t[0] = 20.0
    assert "h2" in hb.dead()


def test_elastic_planner_shrinks_mesh():
    ep = ElasticPlanner(chips_per_host=4, model_axis=16)
    plan = ep.plan([f"h{i}" for i in range(64)])     # 256 chips
    assert plan.shape == (16, 16)
    plan2 = ep.plan([f"h{i}" for i in range(48)])    # lost 16 hosts
    assert plan2.shape == (12, 16)
    with pytest.raises(RuntimeError):
        ep.plan(["h0"])                              # too few for TP=16


def test_elastic_reshard_plan_covers_all_shards():
    ep = ElasticPlanner()
    plan = ep.reshard_plan(old_data=16, new_data=12)
    covered = set()
    for _, olds in plan:
        covered.update(olds)
    assert covered == set(range(16))


# ------------------------------------------------------------------- data
def test_data_deterministic_per_step():
    cfg = tiny_config(ARCH)
    ds = SyntheticLM(cfg, DataConfig(batch=2, seq_len=16, seed=3))
    b1, b2 = ds.batch_at(5), ds.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(ds.batch_at(6)["tokens"], b1["tokens"])
    # the same corpus as the JAX package's
    jb = JaxSyntheticLM(jax_tiny_config(ARCH),
                        JaxDataConfig(batch=2, seq_len=16, seed=3))
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(b1[key], jb.batch_at(5)[key])


def test_prefetcher_async_and_sync_agree():
    cfg = tiny_config(ARCH)
    ds = SyntheticLM(cfg, DataConfig(batch=2, seq_len=16))
    disp = FunctionalityDispatcher()
    pf = Prefetcher(ds, disp, depth=3)
    disp.notify_idle(0)                        # fill queue in "idle" time
    assert pf.fills_async == 3
    got = pf.get(0)
    np.testing.assert_array_equal(got["tokens"], ds.batch_at(0)["tokens"])


def test_train_runs_callbacks_on_runtime_workers(tmp_path, monkeypatch):
    """`train()` runs on a real `TaskRuntime(num_workers=2, mode="ddast")`:
    its idle workers fill the prefetch queue and flush the async
    checkpoint, and no runtime thread outlives the call."""
    runtimes, ran_on = [], {"prefetch": set(), "ckpt": set()}

    class _Runtime(train_mod.TaskRuntime):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runtimes.append(self)

    def record(cls, key):
        orig = cls._callback

        def callback(self, worker_id):
            ran_on[key].add(threading.current_thread())
            return orig(self, worker_id)
        monkeypatch.setattr(cls, "_callback", callback)

    record(Prefetcher, "prefetch")
    record(CheckpointManager, "ckpt")
    monkeypatch.setattr(train_mod, "TaskRuntime", _Runtime)
    out = train(ARCH, tiny=True, steps=22, batch=2, seq=8,
                ckpt_dir=str(tmp_path), device="cpu", log_every=100)
    assert len(out["losses"]) == 22
    (rt,) = runtimes
    assert rt.num_workers == 2 and rt.mode == "ddast"
    workers = set(rt._threads)
    assert len(workers) == 2
    # only the runtime's two workers run the callbacks
    assert ran_on["prefetch"] and ran_on["prefetch"] <= workers
    assert ran_on["ckpt"] and ran_on["ckpt"] <= workers
    assert out["prefetch_async"] > 0
    assert not any(th.is_alive() for th in workers)
    assert not [th for th in threading.enumerate() if th in workers]


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("n", range(1, 9))
def test_microbatch_schedule_matches_jax(n):
    order = microbatch_schedule(n)
    assert order == jts.microbatch_schedule(n)
    assert sorted(order) == list(range(n))


_TCFG = dict(opt=OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10))


def _tiny_f32(tiny, full, arch):
    """The tiny f32 config of `arch`; Jamba's with its whole 8-position
    period and one repeat (tiny_config keeps pattern[:4], which has no
    attention layer)."""
    cfg = tiny(arch).scaled(dtype="float32")
    if arch == JAMBA:
        cfg = cfg.scaled(pattern=full(arch).pattern, repeats=1)
    return cfg


def _bridged(seed=0, arch=ARCH):
    """JAX tiny f32 `arch` (model, params) and the port's model and params
    with the same weights."""
    jm = jax_get_model(_tiny_f32(jax_tiny_config, jax_get_config, arch))
    jp = jm.init_params(jax.random.key(seed))
    tm = get_model(_tiny_f32(tiny_config, get_config, arch), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(1))
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _batches(n, batch=4, seq=16, arch=ARCH):
    ds = SyntheticLM(tiny_config(arch), DataConfig(batch=batch, seq_len=seq))
    out = []
    for i in range(n):
        b = ds.batch_at(i)
        out.append(({k: jnp.asarray(v) for k, v in b.items()},
                    {k: torch.from_numpy(v) for k, v in b.items()}))
    return out


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check_loss_gradients(arch):
    """The total loss (NLL, z-loss and, for MoE, the aux loss) and every
    parameter gradient of tiny f32 `arch`, within 1e-4."""
    jm, jp, tm, tp = _bridged(arch=arch)
    tcfg = TrainConfig(**_TCFG)
    (jb, tb), = _batches(1, arch=arch)
    (jtotal, jmet), jg = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jm, tcfg), has_aux=True))(jp, jb)
    total, met = make_loss_fn(tm, tcfg)(tp, tb)
    names, plist = zip(*tp.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, plist)))
    _close(total, jtotal)
    _close(met["loss"], jmet["loss"])
    _close(met["aux"], jmet["aux"])
    want = jax_grads(tp, jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        _close(g, want[name].numpy())


def test_loss_gradients_match_jax():
    _check_loss_gradients(ARCH)


@pytest.mark.parametrize("arch", MOE_ARCHS + [JAMBA])
def test_moe_loss_gradients_match_jax(arch):
    """The MoE archs' gradients go through `moe_gemm`'s backward (its
    plain version here), the dispatch, the combine and the aux loss;
    Jamba's also through the selective scan, the causal conv and one
    attention layer."""
    _check_loss_gradients(arch)


@pytest.mark.parametrize("microbatches,arch",
                         [(1, ARCH), (2, ARCH), (1, MOE_ARCH), (2, MOE_ARCH),
                          (1, JAMBA)],
                         ids=["1", "2", "moe-1", "moe-2", "jamba-1"])
def test_train_step_matches_jax(microbatches, arch):
    """One JAX step from init makes m, v and step non-trivial; both then
    take the next step from the bridged state on the same batch."""
    jm, jp, tm, tp = _bridged(arch=arch)
    tcfg = TrainConfig(num_microbatches=microbatches, **_TCFG)
    (jb0, _), (jb1, tb1) = _batches(2, arch=arch)
    jstep = jax.jit(jts.make_train_step(jm, tcfg))
    jp, jo, _ = jstep(jp, jopt.init_opt_state(jp), jb0)
    load_jax_params(tp, jax.tree.map(np.asarray, jp))
    opt = load_jax_opt_state(tp, jax.tree.map(np.asarray, jo))
    assert int(opt["step"]) == 1
    jp, jo, jmet = jstep(jp, jo, jb1)
    tp, opt, met = make_train_step(tm, tcfg)(tp, opt, tb1)
    for key in ("loss", "grad_norm", "lr"):
        _close(met[key], jmet[key])
    assert int(opt["step"]) == int(jo["step"]) == 2
    want = jax_grads(tp, jax.tree.map(np.asarray, jp))
    for name, p in tp.named_parameters():
        _close(p, want[name].numpy())
    for key in ("m", "v"):
        want = jax_grads(tp, jax.tree.map(np.asarray, jo[key]))
        for name, t in opt[key].items():
            _close(t, want[name].numpy())


def test_opt_state_bridge_raises_on_missing_leaf():
    _, jp, _, tp = _bridged()
    jo = jax.tree.map(np.asarray, jopt.init_opt_state(jp))
    del jo["v"]["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        load_jax_opt_state(tp, jo)


# ----------------------------------------------------------- end-to-end
def _check_train_and_resume(tmp_path, arch):
    run = dict(tiny=True, batch=4, seq=32, log_every=100, schedule_steps=30,
               device="cpu")
    d1 = str(tmp_path / "a")
    out = train(arch, steps=24, ckpt_dir=d1, **run)
    assert out["final_loss"] < out["losses"][0]   # learning happens
    # resume: continue to 30 from the step-24 checkpoint
    out2 = train(arch, steps=30, ckpt_dir=d1, **run)
    assert len(out2["losses"]) == 6
    # straight-through run to 30 in a fresh dir must match the resumed one
    out3 = train(arch, steps=30, ckpt_dir=str(tmp_path / "b"), **run)
    assert out2["losses"][-1] == pytest.approx(out3["losses"][-1], rel=1e-4)


def test_train_loss_decreases_and_resume_exact(tmp_path):
    _check_train_and_resume(tmp_path, ARCH)


def test_moe_train_loss_decreases_and_resume_exact(tmp_path):
    _check_train_and_resume(tmp_path, MOE_ARCH)


def test_jamba_train_loss_decreases_and_resume_exact(tmp_path):
    """Tiny Jamba (pattern[:4]: Mamba layers, MoE every second one)
    through `train()`."""
    _check_train_and_resume(tmp_path, JAMBA)


def test_train_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        train(ARCH, tiny=True, steps=1, batch=2, seq=8,
              ckpt_dir=str(tmp_path))
