"""The port's dynamic tuner (`repro_torch.core.autotune`) on the CPU: the
JAX package's three tuner tests (manager-pool widening under backlog,
decay when calm, a tuned matmul still correct) on the port, and the
shard hill-climb of both packages fed the same stats sequence giving the
same decisions."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.autotune import DynamicTuner as JTuner  # noqa: E402
from repro.core.autotune import TunerConfig as JConfig  # noqa: E402
from repro_torch.core import DDASTParams, TaskRuntime  # noqa: E402
from repro_torch.core.autotune import DynamicTuner, TunerConfig  # noqa: E402
from repro_torch.core.taskgraph_apps import run_matmul  # noqa: E402


def test_tuner_widens_managers_under_backlog():
    params = DDASTParams(max_ddast_threads=1, max_spins=1, max_ops_thread=8)
    rt = TaskRuntime(num_workers=4, mode="ddast", params=params)
    tuner = DynamicTuner(rt, TunerConfig(interval_s=0.0, backlog_high=4))
    # simulate backlog without starting workers: enqueue many submits
    for _ in range(100):
        rt.worker_queues[0].submit.push(type("M", (), {"wd": None})())
    before = rt.params.max_ddast_threads
    tuner.callback(0)
    assert rt.params.max_ddast_threads == before + 1
    assert rt.params.max_ops_thread > 8


def test_tuner_decays_when_calm():
    params = DDASTParams(max_ddast_threads=3, max_spins=1)
    rt = TaskRuntime(num_workers=8, mode="ddast", params=params)
    tuner = DynamicTuner(rt, TunerConfig(interval_s=0.0))
    tuner._static_mgr = 1
    tuner.callback(0)                       # empty queues -> decay
    assert rt.params.max_ddast_threads == 2


def test_tuner_end_to_end_still_correct():
    params = DDASTParams(max_ddast_threads=1)
    a = np.random.RandomState(0).rand(64, 64).astype(np.float32)
    with TaskRuntime(num_workers=3, mode="ddast", params=params) as rt:
        DynamicTuner(rt, TunerConfig(interval_s=0.0005))
        c = run_matmul(rt, a, a, bs=16, device="cpu")
    np.testing.assert_allclose(c, a @ a, rtol=1e-4, atol=1e-4)
    assert rt.stats.tasks_executed == 4 ** 3


# Per-message lock wait (delegation off) or handoffs (on) fed to the
# hill-climb, one sample a step: improving, worse, worse (bracketed),
# then samples a settled controller must ignore.
METRICS = (1.0, 0.5, 0.9, 1.5, 0.1, 2.0)


def _decisions(core, tuner_cls, cfg_cls, delegation, metrics):
    """Feed `metrics` to a fresh tuner on an unstarted sharded runtime of
    `core`; return each step's (resized, num_shards, settled) and the
    adjustments' shard counts."""
    rt = core.TaskRuntime(num_workers=2, mode="sharded", num_shards=4,
                          delegation=delegation)
    tuner = tuner_cls(rt, cfg_cls(interval_s=0.0, shard_min_messages=10))
    msgs, wait, hand = 0, 0.0, 0
    out = []
    for x in metrics:
        msgs += 100
        if delegation:
            hand += int(x * 100)
        else:
            wait += x * 100
        stats = {"messages_processed": msgs, "lock_wait_s": wait,
                 "shard_lock_handoffs": [hand]}
        out.append((tuner.consider_shard_step(stats), rt.policy.num_shards,
                    tuner.shards_settled))
    return out, [n for _, n in tuner.shard_adjustments]


@pytest.mark.parametrize("delegation", [False, True],
                         ids=["lock_wait", "handoffs"])
@pytest.mark.parametrize("metrics", [METRICS, (1.0, 1.2, 0.8, 0.6, 0.9, 1.1),
                                     (1.3, 1.0, 1.0, 1.0, 1.0, 1.0)],
                         ids=["bracket", "reverse_first", "flat"])
def test_shard_hill_climb_same_decisions(delegation, metrics):
    got = _decisions(tcore, DynamicTuner, TunerConfig, delegation, metrics)
    want = _decisions(jcore, JTuner, JConfig, delegation, metrics)
    assert got == want
    assert got[1], "the climb never resized"


def test_shard_hill_climb_settles_at_the_bracket():
    """The reference's own sequence: 4 -> 8 -> 16, flip to 8, bracketed
    back to 16, then inert."""
    steps, adj = _decisions(tcore, DynamicTuner, TunerConfig, False,
                            METRICS)
    assert adj == [8, 16, 8, 16]
    assert steps[3] == (True, 16, True)
    assert steps[4:] == [(False, 16, True)] * 2


def test_trace_verdicts_widen_managers_after_votes():
    """Starvation verdicts fold into the manager pool after
    `trace_starve_votes` sweeps (fabricated findings)."""
    from repro_torch.core.trace import STARVATION, Finding
    rt = TaskRuntime(num_workers=4, mode="ddast",
                     params=DDASTParams(max_ddast_threads=1))
    tuner = DynamicTuner(rt, TunerConfig(trace_starve_votes=2))
    f = Finding(kind=STARVATION, t0=0.0, t1=1.0, slot=0, count=1)
    assert not tuner.note_trace_verdicts([f])
    assert tuner.note_trace_verdicts([f])
    assert rt.params.max_ddast_threads == 2
    assert [a for _, a in tuner.trace_actions] == ["widen_managers"]
