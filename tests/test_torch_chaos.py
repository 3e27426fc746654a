"""Fault tolerance in the port (`repro_torch.core.procs` chaos and the
threaded scopes), on the CPU: ports of every test of `tests/test_chaos.py`
against the port's `ProcessRuntime` and `TaskRuntime`. Deterministic
fault injection through `FaultPlan`: worker kills mid-run with
retry-to-completion checked serial-exact against the idempotent
ping-pong oracle, seeded kill soaks across policy modes, fail-fast
``retries=0``, body-error retry/poison with attempt history, timeout
kills (recovered and poisoned; the retry of
`test_timeout_kill_then_retry_succeeds` lands on a freshly respawned
worker and keeps ``timeout=0.3``, which the READY handshake makes
possible), dropped/delayed done frames, CRC-guarded ring frames and
corrupt-frame respawn, shutdown escalation to SIGKILL, shm and
semaphore leak scans; then the threaded side: per-scope failure
isolation, scope deadlines and budgets, threaded retries, fault events
in the trace. The kill soak also runs the stencil on CPU device arrays.

The bodies are the port's `procs.chaos` ones (the fork server preloads
that module); `_serial_pingpong` is the reference's pure-Python oracle."""
import time

import pytest
import torch

from repro_torch.core import (FaultPlan, ProcessRuntime, RingCorruption,
                              ScopeExpired, ShmRing, TaskFailed, TaskRuntime,
                              WorkerLost)
from repro_torch.core.procs import apps, chaos
from repro_torch.core.trace import (EV_RESPAWN, EV_RETRY, EV_SCOPE_EXPIRED,
                                    EV_TIMEOUT_KILL, EV_TRACE_LOST,
                                    EV_WORKER_LOST)


# ------------------------------------------------------------ oracle app
def _submit_pingpong(rt, n0, n1, n, g0, stages, retries=0, timeout=None,
                     spin_us=0.0):
    return chaos.submit_pingpong(rt, n0, n1, n, g0, stages,
                                 retries=retries, timeout=timeout,
                                 spin_us=spin_us)


def _serial_pingpong(init, n, stages):
    bufs = [list(init), [0.0] * n]
    for g in range(stages):
        src, dst = bufs[g % 2], bufs[(g + 1) % 2]
        for i in range(n):
            dst[i] = (src[(i - 1) % n] + src[i] + src[(i + 1) % n]) \
                * 0.5 + 1.0
    return bufs[stages % 2]


def _pingpong_arrays(n, seed=7):
    b0, b1 = apps.ShmArray(n), apps.ShmArray(n)
    apps.fill_deterministic(b0, seed)
    return b0, b1


def _drain(shms):
    for s in shms:
        s.close_unlink()


# ------------------------------------------------------------ kill+retry
def test_kill_and_retry_serial_exact():
    n, stages = 6, 4
    b0, b1 = _pingpong_arrays(n)
    init = b0.tolist()
    try:
        plan = FaultPlan().kill_worker(1, after_tasks=5)
        with ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            fault_plan=plan) as rt:
            _submit_pingpong(rt, b0.name, b1.name, n, 0, stages,
                             retries=2, spin_us=300.0)
            rt.taskwait()
        assert (b0.tolist() if stages % 2 == 0 else b1.tolist()) \
            == _serial_pingpong(init, n, stages)
        assert rt.stats.worker_respawns >= 1
        assert rt.stats.tasks_executed == n * stages
        assert rt.stats.leaked_shm == []
    finally:
        _drain([b0, b1])


def test_retries_zero_fail_fast():
    n = 6
    b0, b1 = _pingpong_arrays(n)
    try:
        plan = FaultPlan().kill_worker(0, after_tasks=3)
        rt = ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            fault_plan=plan)
        rt.start()
        _submit_pingpong(rt, b0.name, b1.name, n, 0, 4, retries=0,
                         spin_us=500.0)
        with pytest.raises(WorkerLost):
            rt.taskwait()
        rt.shutdown()                    # must not hang or respawn
        assert rt.stats.worker_respawns == 0
        assert rt.stats.leaked_shm == []
    finally:
        _drain([b0, b1])


@pytest.mark.parametrize("mode", ["sharded", "ddast"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_kill_soak(mode, seed):
    """The chaos soak: a seeded random kill plan (two kills at distinct
    shipped-task counts) must still produce the serial-exact answer with
    no leaked shm; a failing seed is a one-line repro."""
    n, stages = 6, 4
    b0, b1 = _pingpong_arrays(n, seed=seed)
    init = b0.tolist()
    try:
        plan = FaultPlan.seeded_kills(seed, num_workers=2,
                                      total_tasks=n * stages, kills=2)
        with ProcessRuntime(num_workers=2, mode=mode, ipc_batch=1,
                            fault_plan=plan) as rt:
            _submit_pingpong(rt, b0.name, b1.name, n, 0, stages,
                             retries=3, spin_us=300.0)
            rt.taskwait()
        assert b0.tolist() == _serial_pingpong(init, n, stages)
        assert rt.stats.leaked_shm == []
    finally:
        _drain([b0, b1])


@pytest.mark.parametrize("seed", [1, 2])
def test_seeded_kill_on_device_arrays(seed):
    """Phase 35's kill check at a CPU size: the stencil on device arrays
    (the tensor body) survives a seeded kill, serial-exact against the
    same calls run in this process, with nothing leaked."""
    n, stages = 6, 4
    b0, b1 = (apps.DeviceArray(n, torch.float64, device="cpu")
              for _ in range(2))
    s0, s1 = (apps.DeviceArray(n, torch.float64, device="cpu")
              for _ in range(2))
    try:
        init = torch.rand(n, generator=torch.Generator().manual_seed(seed),
                          dtype=torch.float64)
        b0.tensor.copy_(init)
        s0.tensor.copy_(init)
        plan = FaultPlan.seeded_kills(seed, num_workers=2,
                                      total_tasks=n * stages, kills=1)
        with ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            fault_plan=plan) as rt:
            calls = _submit_pingpong(rt, b0.name, b1.name, n, 0, stages,
                                     retries=3, spin_us=300.0)
            rt.taskwait()
        apps.run_serial([(f, (s0.name, s1.name) + a[2:], d, l)
                         for f, a, d, l in calls])
        assert torch.equal(b0.tensor, s0.tensor)
        assert b0.tolist() == pytest.approx(
            _serial_pingpong(init.tolist(), n, stages), rel=1e-15)
        assert rt.stats.worker_respawns >= 1
        assert rt.stats.leaked_shm == []
    finally:
        _drain([b0, b1, s0, s1])


def test_seeded_kills_deterministic():
    a = FaultPlan.seeded_kills(42, 4, 100)
    b = FaultPlan.seeded_kills(42, 4, 100)
    c = FaultPlan.seeded_kills(43, 4, 100)
    sig = lambda p: [(e[0], e[1]) for e in p._kills]
    assert sig(a) == sig(b)
    assert sig(a) != sig(c)


# ------------------------------------------------------------ body errors
def test_body_error_retried_then_succeeds():
    flag, out = apps.ShmArray(4), apps.ShmArray(4)
    try:
        with ProcessRuntime(num_workers=2, mode="sync") as rt:
            for i in range(4):
                rt.task(chaos.fail_once, flag.name, out.name, i,
                        label=f"flaky{i}", retries=1)
            rt.taskwait()
        assert out.tolist() == [1.0, 2.0, 3.0, 4.0]
        assert rt.stats.task_retries == 4
        assert rt.stats.tasks_poisoned == 0
    finally:
        _drain([flag, out])


def test_body_error_poisoned_with_attempt_history():
    rt = ProcessRuntime(num_workers=1, mode="sync")
    rt.start()
    rt.task(chaos.always_fails, label="doomed", retries=2)
    with pytest.raises(TaskFailed, match="permanent failure") as ei:
        rt.taskwait()
    rt.shutdown()
    (label, tb, attempts), = ei.value.failures
    assert label == "doomed"
    assert "permanent failure" in tb
    assert len(attempts) == 2            # two retries before poisoning
    assert all(a["reason"] == "error" for a in attempts)
    assert rt.stats.tasks_poisoned == 1
    assert rt.stats.task_retries == 2


# ------------------------------------------------------------ timeouts
def test_timeout_kill_then_retry_succeeds():
    flag, out = apps.ShmArray(2), apps.ShmArray(2)
    try:
        with ProcessRuntime(num_workers=2, mode="sharded",
                            ipc_batch=1) as rt:
            rt.task(chaos.stall_once_then_write, flag.name, out.name, 0,
                    label="stuck", retries=1, timeout=0.3)
            rt.task(chaos.write_index, out.name, 1, label="bystander")
            rt.taskwait()
        assert out.tolist() == [1.0, 2.0]
        assert rt.stats.timeout_kills >= 1
        assert rt.stats.task_retries >= 1
        assert rt.stats.worker_respawns >= 1
    finally:
        _drain([flag, out])


def test_timeout_retries_exhausted_poisons():
    plan = FaultPlan().stall_body("wedged", 5.0, times=4)
    rt = ProcessRuntime(num_workers=1, mode="sync", ipc_batch=1,
                        fault_plan=plan)
    rt.start()
    rt.task(apps.spin, 10.0, label="wedged", retries=0, timeout=0.25)
    with pytest.raises(TaskFailed, match="timeout") as ei:
        rt.taskwait()
    rt.shutdown()
    (label, reason, attempts), = ei.value.failures
    assert label == "wedged"
    assert attempts and attempts[0]["reason"] == "timeout"
    assert rt.stats.timeout_kills >= 1
    assert rt.stats.tasks_poisoned == 1


# ------------------------------------------------------------ done frames
def test_dropped_done_frame_recovered_by_timeout():
    """A swallowed done frame is indistinguishable from a stuck task:
    only the deadline recovers it (kill + respawn + retry)."""
    out = apps.ShmArray(6)
    try:
        plan = FaultPlan().drop_done(0, nth=1)
        with ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            fault_plan=plan) as rt:
            for i in range(6):
                rt.task(chaos.write_index, out.name, i, label=f"w{i}",
                        retries=1, timeout=0.8)
            rt.taskwait()
        assert out.tolist() == [float(i + 1) for i in range(6)]
        assert rt.stats.timeout_kills >= 1
        assert rt.stats.task_retries >= 1
    finally:
        _drain([out])


def test_delayed_done_frame_is_harmless():
    out = apps.ShmArray(4)
    try:
        plan = FaultPlan().delay_done(0, nth=1, delay_s=0.05)
        with ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            fault_plan=plan) as rt:
            for i in range(4):
                rt.task(chaos.write_index, out.name, i, label=f"w{i}")
            rt.taskwait()
        assert out.tolist() == [1.0, 2.0, 3.0, 4.0]
        assert rt.stats.task_retries == 0
    finally:
        _drain([out])


# ------------------------------------------------------------ transport
def test_ring_crc_detects_corruption_and_advances():
    ring = ShmRing(capacity=256)
    try:
        ring._corrupt_next = True
        ring.push(b"poisoned-frame")
        ring.push(b"good-frame")
        with pytest.raises(RingCorruption):
            ring.pop()
        # head advanced past the bad frame: the stream continues
        assert ring.pop() == b"good-frame"
        assert ring.pop() is None
    finally:
        ring.close()
        ring.unlink()


def test_corrupt_exec_frame_respawns_worker():
    """A corrupt exec frame trips the worker-side CRC check; the worker
    exits, the supervisor respawns it, and the lost task retries."""
    out = apps.ShmArray(6)
    try:
        plan = FaultPlan().corrupt_exec_frame(0, nth=1)
        with ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            fault_plan=plan) as rt:
            for i in range(6):
                rt.task(chaos.write_index, out.name, i, label=f"w{i}",
                        retries=1)
            rt.taskwait()
        assert out.tolist() == [float(i + 1) for i in range(6)]
        assert rt.stats.worker_respawns >= 1
        assert rt.stats.task_retries >= 1
    finally:
        _drain([out])


# ------------------------------------------------------------ shutdown
def test_shutdown_escalates_to_sigkill_for_zombies():
    plan = FaultPlan().stall_body("zzz", 30.0, times=4)
    plan.ignore_sigterm = True
    rt = ProcessRuntime(num_workers=2, mode="sync", ipc_batch=1,
                        fault_plan=plan, shutdown_grace=0.3)
    rt.start()
    for i in range(2):
        rt.task(apps.spin, 1.0, label=f"zzz{i}")
    time.sleep(0.3)                      # let both workers wedge
    rt._teardown()                       # no taskwait: straight down
    rt._aggregate_stats()
    assert rt.stats.zombie_workers >= 1
    assert rt.stats.leaked_shm == []


def test_clean_run_reports_no_faults():
    out = apps.ShmArray(4)
    try:
        with ProcessRuntime(num_workers=2, mode="sharded") as rt:
            for i in range(4):
                rt.task(chaos.write_index, out.name, i, label=f"w{i}")
            rt.taskwait()
        st = rt.stats
        assert (st.worker_respawns, st.task_retries, st.tasks_poisoned,
                st.timeout_kills, st.transport_errors,
                st.zombie_workers) == (0, 0, 0, 0, 0, 0)
        assert st.leaked_shm == []
    finally:
        _drain([out])


# ------------------------------------------------------------ traces
def test_fault_events_land_in_trace():
    n, stages = 6, 4
    b0, b1 = _pingpong_arrays(n)
    try:
        plan = FaultPlan().kill_worker(1, after_tasks=4)
        with ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            trace=True, fault_plan=plan) as rt:
            _submit_pingpong(rt, b0.name, b1.name, n, 0, stages,
                             retries=2, spin_us=2000.0)
            rt.taskwait()
        evs = {e.ev for e in rt.stats.events}
        assert EV_WORKER_LOST in evs
        assert EV_RESPAWN in evs
        if rt.stats.trace_lost:          # tasks were in flight at kill
            assert EV_TRACE_LOST in evs
            assert EV_RETRY in evs
    finally:
        _drain([b0, b1])


def test_timeout_kill_traced():
    plan = FaultPlan().stall_body("wedged", 5.0, times=4)
    rt = ProcessRuntime(num_workers=1, mode="sync", ipc_batch=1,
                        trace=True, fault_plan=plan)
    rt.start()
    rt.task(apps.spin, 10.0, label="wedged", retries=0, timeout=0.25)
    with pytest.raises(TaskFailed):
        rt.taskwait()
    rt.shutdown()
    assert EV_TIMEOUT_KILL in {e.ev for e in rt.stats.events}


# ------------------------------------------------------------ replay plane
def test_plane_recovery_after_iter_kill():
    """Kill a worker during a replayed-plane iteration: only the dead
    worker's claimed tasks retry; the runtime falls back to live
    analysis for the rest of that iteration and completes
    serial-exact."""
    n, per_iter, iters = 6, 2, 4
    b0, b1 = _pingpong_arrays(n)
    init = b0.tolist()
    try:
        plan = FaultPlan().kill_worker_at_iter(1, nth_iter=1)
        with ProcessRuntime(num_workers=2, mode="sharded", replay=True,
                            ipc_batch=1, fault_plan=plan) as rt:
            for it in range(iters):
                # same structure each iteration (generation parity
                # repeats every 2 stages) so the plane can freeze it
                _submit_pingpong(rt, b0.name, b1.name, n, 0, per_iter,
                                 retries=1, spin_us=2000.0)
                rt.taskwait()
        final = _serial_pingpong(init, n, per_iter)
        for _ in range(iters - 1):
            final = _serial_pingpong(final, n, per_iter)
        assert b0.tolist() == final
        assert rt.stats.tasks_executed == n * per_iter * iters
        assert rt.stats.worker_respawns >= 1
        assert rt.stats.leaked_shm == []
    finally:
        _drain([b0, b1])


def test_plane_kill_retries_zero_fails_fast():
    n = 6
    b0, b1 = _pingpong_arrays(n)
    try:
        plan = FaultPlan().kill_worker_at_iter(0, nth_iter=1)
        rt = ProcessRuntime(num_workers=2, mode="sharded", replay=True,
                            ipc_batch=1, fault_plan=plan)
        rt.start()
        raised = False
        try:
            for _ in range(4):
                _submit_pingpong(rt, b0.name, b1.name, n, 0, 2,
                                 retries=0, spin_us=2000.0)
                rt.taskwait()
        except WorkerLost:
            raised = True
        assert raised
        rt.shutdown()
        assert rt.stats.leaked_shm == []
    finally:
        _drain([b0, b1])


# ------------------------------------------------------------ scopes
def test_scope_failure_isolated_to_owner():
    rt = TaskRuntime(num_workers=2, num_clients=2)
    rt.start()
    a, b = rt.open_scope("a"), rt.open_scope("b")
    a.task(chaos.always_fails, label="boomA")
    b.task(apps.spin, 1.0, label="okB")
    b.taskwait()                         # unaffected tenant: no raise
    rt.taskwait()                        # root: no raise either
    with pytest.raises(TaskFailed, match="boomA"):
        a.taskwait()
    rt.shutdown()                        # error consumed: clean exit


def test_scope_deadline_expires_and_drains():
    rt = TaskRuntime(num_workers=2, num_clients=2)
    rt.start()
    slow = rt.open_scope("slow", deadline=0.15)
    ok = rt.open_scope("ok")
    for i in range(30):
        slow.task(time.sleep, 0.02, label=f"s{i}")
    for i in range(5):
        ok.task(apps.spin, 10.0, label=f"o{i}")
    ok.taskwait()                        # neighbor tenant unaffected
    with pytest.raises(ScopeExpired, match="deadline"):
        slow.taskwait()
    assert slow.drained > 0
    rt.shutdown()
    assert rt.stats.scopes_expired == 1
    assert rt.stats.scopes["slow"]["expired"].startswith("deadline")


def test_scope_budget_expires():
    rt = TaskRuntime(num_workers=2, num_clients=1, trace=True)
    rt.start()
    sc = rt.open_scope("metered", budget=0.02)
    for i in range(40):
        sc.task(time.sleep, 0.005, label=f"m{i}")
    with pytest.raises(ScopeExpired, match="budget"):
        sc.close()
    rt.shutdown()
    assert rt.stats.scopes["metered"]["budget_used_s"] > 0.02
    assert EV_SCOPE_EXPIRED in {e.ev for e in rt.stats.events}


def test_threaded_retries_and_poison():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("transient")
        return 99

    with TaskRuntime(num_workers=2) as rt:
        t = rt.task(flaky, label="flaky", retries=1)
        rt.taskwait()
        assert t.result == 99
    assert rt.stats.task_retries == 1

    rt = TaskRuntime(num_workers=2)
    rt.start()
    rt.task(chaos.always_fails, label="doomed", retries=1)
    with pytest.raises(TaskFailed, match="permanent failure") as ei:
        rt.taskwait()
    rt.shutdown()
    (_, _, attempts), = ei.value.failures
    assert len(attempts) == 1
    assert rt.stats.tasks_poisoned == 1


# ------------------------------------------------------------ acceptance
def test_process_faults_leave_threaded_scopes_unaffected():
    """A process-backend run surviving a worker kill via retries while a
    threaded JobScope in the same parent runs to completion, untouched."""
    trt = TaskRuntime(num_workers=2, num_clients=1)
    trt.start()
    sc = trt.open_scope("tenant")
    for i in range(12):
        sc.task(apps.spin, 50.0, label=f"bg{i}")

    n, stages = 6, 4
    b0, b1 = _pingpong_arrays(n)
    init = b0.tolist()
    try:
        plan = FaultPlan().kill_worker(0, after_tasks=6)
        with ProcessRuntime(num_workers=2, mode="sharded", ipc_batch=1,
                            fault_plan=plan) as prt:
            _submit_pingpong(prt, b0.name, b1.name, n, 0, stages,
                             retries=1, spin_us=300.0)
            prt.taskwait()
        assert b0.tolist() == _serial_pingpong(init, n, stages)
        assert prt.stats.worker_respawns >= 1
        assert prt.stats.leaked_shm == []
    finally:
        _drain([b0, b1])

    sc.close()                           # no raise: tenant unaffected
    trt.shutdown()
    assert trt.stats.tasks_executed >= 12
