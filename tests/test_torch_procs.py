"""The port's process backend (`repro_torch.core.procs`) on the CPU.

Ports of every test of `tests/test_procs.py` and of the two
process-backend tests of `tests/test_metrics.py` against the port's
`ProcessRuntime`; parity with the JAX package's backend (`repro.core`):
the three host apps give equal values and equal serial results on the
same seeds, the wire and ring frames are byte-equal, merged traces have
the same event kinds and `RuntimeStats` the same fields; the start
method (never `fork`), the parent watchdog under the fork server, the
READY handshake, and device arrays on the CPU (a tensor over a
shared-memory segment: the attach path, the tensor bodies of every
kernel, serial-exact across both backends). A CUDA IPC handle cannot be
made here; `chip_smoke.py` phase 35 holds the card's path.

The task bodies come from the port's `procs.apps` and `procs.chaos`,
which the fork server preloads: a body defined in this file would make
every fresh worker import it (and pytest) on its first task."""
import dataclasses
import inspect
import os
import pickle
import subprocess
import sys
import textwrap
import time

import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import messages as jmessages
from repro.core.procs import apps as japps
from repro.core.procs import serial as jserial
from repro_torch.core import (ProcessRuntime, RuntimeStats, ShmRing,
                              SimCosts, TaskFailed, TaskRuntime, WorkerLost)
from repro_torch.core.engine.charge import SimCharger
from repro_torch.core.messages import (DONE_ERROR, DONE_OK,
                                       decode_done_batch,
                                       decode_submit_batch,
                                       encode_done_batch,
                                       encode_submit_batch)
from repro_torch.core.metrics import PLANE_FIELDS
from repro_torch.core.procs import apps, chaos, serial
from repro_torch.core.trace import EV_CREATED, EV_END, EV_START

PROC_MODES = ("sync", "dast", "ddast", "sharded")
JOIN_S = 30.0


def _drain(shms):
    for s in shms:
        s.close_unlink()


def _assert_no_leaks(rt):
    names = rt.shm_names()
    rt.shutdown()
    leaked = [n for n in names if os.path.exists("/dev/shm/" + n)]
    assert not leaked, f"leaked shm segments: {leaked}"
    assert rt.stats.leaked_shm == []     # rings, planes and semaphores


def _rename(calls, mapping):
    """The same calls on other arrays: each name in ``mapping`` swapped."""
    return [(f, tuple(mapping.get(x, x) for x in a), d, l)
            for f, a, d, l in calls]


# ------------------------------------------------------------ oracles
def _oracle_matmul(mode, replay=False, iterations=1):
    N, bs = 3, 3
    A = apps.ShmArray((N * bs) ** 2)
    B = apps.ShmArray((N * bs) ** 2)
    C = apps.ShmArray((N * bs) ** 2)
    C2 = apps.ShmArray((N * bs) ** 2)
    apps.fill_deterministic(A, 3)
    apps.fill_deterministic(B, 5)
    try:
        rt = ProcessRuntime(num_workers=2, mode=mode, replay=replay)
        with rt:
            for _ in range(iterations):
                calls = apps.submit_matmul(rt, A.name, B.name, C.name,
                                           N, bs)
                rt.taskwait()
        for _ in range(iterations):
            apps.run_serial(_rename(calls, {C.name: C2.name}))
        assert C.tolist() == C2.tolist()
        return rt
    finally:
        _drain([A, B, C, C2])


@pytest.mark.parametrize("mode", ["sync", "sharded"])
def test_matmul_matches_serial(mode):
    rt = _oracle_matmul(mode)
    assert rt.stats.tasks_executed == 27


def test_sparselu_matches_serial():
    nb, bs = 4, 3
    M = apps.ShmArray(nb * nb * bs * bs)
    M2 = apps.ShmArray(nb * nb * bs * bs)
    apps.fill_deterministic(M, 11)
    apps.fill_deterministic(M2, 11)
    try:
        with ProcessRuntime(num_workers=2, mode="sharded") as rt:
            calls = apps.submit_sparselu(rt, M.name, nb, bs)
            rt.taskwait()
        apps.run_serial(_rename(calls, {M.name: M2.name}))
        assert M.tolist() == M2.tolist()
    finally:
        _drain([M, M2])


def test_nbody_matches_serial():
    n = 8
    arrs = [apps.ShmArray(n) for _ in range(6)]
    P, V, A, P2, V2, A2 = arrs
    apps.fill_deterministic(P, 2)
    apps.fill_deterministic(P2, 2)
    try:
        with ProcessRuntime(num_workers=2, mode="ddast") as rt:
            calls = apps.submit_nbody(rt, P.name, V.name, A.name, n,
                                      steps=2)
            rt.taskwait()
        apps.run_serial(_rename(calls, {P.name: P2.name, V.name: V2.name,
                                        A.name: A2.name}))
        assert P.tolist() == P2.tolist()
        assert V.tolist() == V2.tolist()
    finally:
        _drain(arrs)


def test_dependence_order_from_exec_spans():
    """Worker-stamped exec spans must respect every region edge:
    pred.t_end <= succ.t_start (one monotonic clock across processes)."""
    n = 6
    P, V, A = (apps.ShmArray(n) for _ in range(3))
    apps.fill_deterministic(P, 4)
    try:
        wds = []
        with ProcessRuntime(num_workers=2, mode="sharded") as rt:
            all_pos = [(("P", j), "in") for j in range(n)]
            for s in range(2):
                for i in range(n):
                    wds.append(rt.task(
                        apps.nbody_force, P.name, A.name, n, i,
                        deps=all_pos + [(("A", i), "out")],
                        label=f"force[{s},{i}]"))
                for i in range(n):
                    wds.append(rt.task(
                        apps.nbody_update, P.name, V.name, A.name, i,
                        deps=[(("A", i), "in"), (("V", i), "inout"),
                              (("P", i), "inout")],
                        label=f"update[{s},{i}]"))
            rt.taskwait()
        span = {wd.label: wd.exec_span for wd in wds}
        for s in range(2):
            for i in range(n):
                force_end = span[f"force[{s},{i}]"][1]
                upd_start = span[f"update[{s},{i}]"][0]
                assert force_end <= upd_start
                if s:
                    # update[s-1, j] writes P[j], force[s, i] reads all P
                    for j in range(n):
                        assert span[f"update[{s-1},{j}]"][1] <= \
                            span[f"force[{s},{i}]"][0]
    finally:
        _drain([P, V, A])


# ------------------------------------------------------------ replay
def test_replay_steady_state_zero_ipc():
    A = apps.ShmArray(8)
    apps.fill_deterministic(A, 9)
    ref = apps.ShmArray(8)
    apps.fill_deterministic(ref, 9)
    iters = 6
    try:
        with ProcessRuntime(num_workers=2, mode="sharded",
                            replay=True) as rt:
            for _ in range(iters):
                calls = []
                for i in range(10):
                    args = (A.name, A.name, A.name, i % 4)
                    calls.append((apps.nbody_update, args, None, None))
                    rt.task(apps.nbody_update, *args,
                            deps=[(("X", i % 4), "inout")], label=f"t{i}")
                rt.taskwait()
        # iteration 0 records (live mailbox traffic); every later
        # iteration runs on the shared replay plane: 0 Submit/Done
        # frames cross the process boundary
        assert rt.iter_ipc[0][0] > 0
        for sub, done in rt.iter_ipc[1:iters]:
            assert (sub, done) == (0, 0)
        assert rt.stats.replay_iterations >= iters - 2
        # and the data plane stayed correct through the replays
        for _ in range(iters):
            apps.run_serial([(f, (ref.name, ref.name, ref.name, a[3]),
                              None, None) for f, a, _d, _l in calls])
        assert A.tolist() == ref.tolist()
    finally:
        _drain([A, ref])


def test_replay_divergence_falls_back_live():
    A = apps.ShmArray(4)
    try:
        with ProcessRuntime(num_workers=1, mode="sharded",
                            replay=True) as rt:
            for it in range(4):
                n = 4 if it < 2 else 6      # structure changes at it=2
                for i in range(n):
                    rt.task(apps.nbody_update, A.name, A.name, A.name,
                            i % 2, deps=[(("X", i % 2), "inout")],
                            label=f"t{i}")
                rt.taskwait()
            assert rt.stats.tasks_executed == 4 + 4 + 6 + 6
    finally:
        _drain([A])


# ------------------------------------------------------------ traces
def _trace_run(core, backend, mode="sharded"):
    A = apps.ShmArray(4)
    try:
        with core.TaskRuntime(num_workers=2, mode=mode, trace=True,
                              backend=backend) as rt:
            for i in range(8):
                rt.task(apps.nbody_update, A.name, A.name, A.name,
                        i % 2, deps=[(("X", i % 2), "inout")],
                        label=f"t{i}")
            rt.taskwait()
        return rt.stats.events
    finally:
        _drain([A])


def test_trace_schema_agrees_with_threads():
    """Same workload, both drivers, trace=True: the merged event lists
    agree on the lifecycle multiset per label, worker events land on
    worker slots, and both are time-sorted."""
    evs_t = _trace_run(tcore, "threads")
    evs_p = _trace_run(tcore, "processes")
    lifecycle = (EV_CREATED, EV_START, EV_END)

    def sig(evs):
        return sorted((e.label, e.ev) for e in evs
                      if e.ev in lifecycle and e.label.startswith("t"))

    assert sig(evs_t) == sig(evs_p)
    for evs in (evs_t, evs_p):
        assert [e.t for e in evs] == sorted(e.t for e in evs)
    # process-backend bodies run on worker slots (2 + widx)
    for e in evs_p:
        if e.ev in (EV_START, EV_END) and e.label.startswith("t"):
            assert e.slot >= 2


# ------------------------------------------------------------ failures
def test_worker_death_raises_worker_lost():
    rt = ProcessRuntime(num_workers=2, mode="sharded")
    rt.start()
    rt.task(chaos.kill_self, label="victim")
    with pytest.raises(WorkerLost, match="victim"):
        rt.taskwait()
    rt.shutdown()                        # must not hang


def test_body_error_raises_task_failed():
    rt = ProcessRuntime(num_workers=1, mode="sync")
    rt.start()
    rt.task(chaos.always_fails, "intentional kernel failure", label="bad")
    with pytest.raises(TaskFailed, match="intentional kernel failure"):
        rt.taskwait()
    rt.shutdown()


def test_unpicklable_task_rejected():
    with ProcessRuntime(num_workers=1) as rt:
        with pytest.raises(ValueError, match="picklable"):
            rt.task(lambda: None, label="lam")
        rt.taskwait()


# ------------------------------------------------------------ lifecycle
@pytest.mark.parametrize("mode", PROC_MODES)
def test_clean_shutdown_no_shm_leaks(mode):
    for _ in range(3):
        rt = ProcessRuntime(num_workers=2, mode=mode, replay=True)
        rt.start()
        for i in range(6):
            rt.task(apps.spin, 10.0, deps=[(("R", i % 2), "inout")],
                    label=f"s{i}")
        rt.taskwait()
        _assert_no_leaks(rt)


def test_results_round_trip():
    with ProcessRuntime(num_workers=1) as rt:
        wd = rt.task(sum, (1, 2, 3), label="sum")
        rt.taskwait()
        assert wd.result == 6


def test_backend_dispatch_and_validation():
    rt = TaskRuntime(num_workers=1, backend="processes")
    assert isinstance(rt, ProcessRuntime)
    rt.start()
    rt.shutdown()
    with pytest.raises(ValueError, match="backend"):
        TaskRuntime(backend="sidecars")
    with pytest.raises(TypeError):       # backend is keyword-only
        TaskRuntime(1, "sync", None, False, None, None, None,
                    "round_robin", False, 0, True, "processes")
    with pytest.raises(ValueError, match="scopes"):
        ProcessRuntime(num_clients=2)
    with pytest.raises(ValueError, match="mode"):
        ProcessRuntime(mode="warp")


# ------------------------------------------------------------ rings
def test_ring_wraparound():
    ring = ShmRing(capacity=256)
    try:
        payload = bytes(range(64))
        for _ in range(50):              # forces many wraps
            assert ring.try_push(payload)
            assert ring.pop() == payload
        assert ring.pop() is None
    finally:
        ring.close()
        ring.unlink()


def test_ring_fifo_and_backpressure():
    ring = ShmRing(capacity=256)
    try:
        frames = [bytes([i]) * 20 for i in range(14)]
        pushed = [f for f in frames if ring.try_push(f)]
        assert len(pushed) < len(frames)            # filled up
        assert ring.try_push(frames[0]) is False    # full: rejected
        assert [ring.pop() for _ in pushed] == pushed
    finally:
        ring.close()
        ring.unlink()


def test_ring_oversize_falls_back_in_order():
    import queue

    class FakeQueue:
        def __init__(self):
            self.q = queue.SimpleQueue()
        put = property(lambda s: s.q.put)
        get = property(lambda s: s.q.get)

    fb = FakeQueue()
    ring = ShmRing(capacity=256, fallback=fb)
    try:
        big = b"B" * 200                 # > capacity // 2: fallback lane
        ring.push(b"first")
        ring.push(big)
        ring.push(b"last")
        assert ring.pop() == b"first"
        assert ring.pop() == big         # FIFO preserved via marker
        assert ring.pop() == b"last"
        assert ring.fallbacks == 1
    finally:
        ring.close()
        ring.unlink()


def test_ring_attach_reads_header_capacity():
    ring = ShmRing(capacity=256)
    try:
        peer = ShmRing.attach(ring.name)
        # logical capacity comes from the header, never from shm.size
        # (page-rounded on some platforms)
        assert peer.capacity == ring.capacity == 256
        peer.close()
    finally:
        ring.close()
        ring.unlink()


def test_fallback_timeout_orphans_nothing():
    import queue

    fb = queue.SimpleQueue()
    ring = ShmRing(capacity=64, fallback=fb)
    try:
        while ring.try_push(b"x" * 8):   # 16-byte frames pack the ring
            pass                         # solid: no room for a marker
        big = b"B" * 60                  # oversize: fallback lane only
        assert ring._push_fallback(big, spin_s=0.01) is False
        assert fb.empty()                # timed out without enqueueing
        with pytest.raises(BufferError):
            ring.push(big, spin_s=0.01)  # retries may not double-enqueue
        assert fb.empty()
        assert ring.fallbacks == 0
    finally:
        ring.close()
        ring.unlink()


def test_push_waits_for_slow_but_live_consumer():
    ring = ShmRing(capacity=64)
    try:
        while ring.try_push(b"x" * 8):
            pass
        ring.consumer_alive = lambda: False
        with pytest.raises(BufferError):
            ring.push(b"y" * 8, spin_s=0.01)

        def probe():                     # live consumer making progress
            ring.pop()
            return True

        ring.consumer_alive = probe
        ring.push(b"y" * 8, spin_s=0.01)
        last = None
        while True:
            frame = ring.pop()
            if frame is None:
                break
            last = frame
        assert last == b"y" * 8
    finally:
        ring.close()
        ring.unlink()


# ------------------------------------------------------------ codecs
def test_wire_codec_roundtrips():
    sub = [(7, pickle.dumps((sum, ((1, 2),))), "alpha"),
           (2 ** 40, b"", "")]
    assert decode_submit_batch(encode_submit_batch(sub)) == sub
    done = [(7, 1.25, 2.5, DONE_OK, pickle.dumps(3)),
            (9, 0.0, 0.5, DONE_ERROR, "tb".encode())]
    assert decode_done_batch(encode_done_batch(done)) == done


# ------------------------------------------------------------ sim knobs
def test_sim_costs_ipc_knobs():
    costs = SimCosts(ipc_submit_us=5.0, ipc_done_us=3.0)
    ch = SimCharger(costs)
    ch.ipc_submit()
    ch.ipc_done()
    assert ch.now == pytest.approx(8.0)
    assert SimCosts().ipc_submit_us > 0
    assert SimCosts().ipc_done_us > 0


# ------------------------------------------ metrics (tests/test_metrics.py)
def test_procs_metrics_plane_totals_and_no_leak():
    with TaskRuntime(4, backend="processes", metrics=True,
                     metrics_interval_s=1e-3) as rt:
        for i in range(48):
            rt.task(apps.spin, 100.0, label=f"t{i}")
        rt.taskwait()
        live = rt.metrics()
        assert live["workers"]["totals"]["tasks_finished"] == 48.0
        assert len(live["workers"]["per_worker"]) == 4
        assert live["sampler"]["samples"] >= 1
    m = rt.stats.metrics
    assert m["workers"]["totals"]["tasks_started"] == 48.0
    assert m["workers"]["totals"]["exec_time_s"] > 0.0
    # no body touched CUDA: the port's sync column stays 0
    assert m["workers"]["totals"]["sync_time_s"] == 0.0
    assert m["gauges"]["ipc_done_msgs"] > 0
    assert rt.leaked_shm == []        # plane unlinked with the rings


@pytest.mark.parametrize("mode", ("sync", "sharded"))
def test_procs_metrics_lifecycle_modes(mode):
    with TaskRuntime(2, backend="processes", mode=mode,
                     metrics=True) as rt:
        for i in range(16):
            rt.task(apps.spin, 50.0, label=f"t{i}")
        rt.taskwait()
    totals = rt.stats.metrics["workers"]["totals"]
    assert totals["tasks_finished"] == 16.0
    assert rt.leaked_shm == []


def test_plane_fields_extend_the_reference():
    from repro.core.metrics import PLANE_FIELDS as JFIELDS
    assert PLANE_FIELDS == JFIELDS + ("sync_time_s",)


# ------------------------------------------------- parity with the JAX package
def _host_app(pkg_apps, core, app, mode):
    """Run one host app on ``core``'s process backend and serially on a
    second set of arrays; returns (parallel values, serial values)."""
    if app == "matmul":
        N, bs = 3, 3
        arrs = [pkg_apps.ShmArray((N * bs) ** 2) for _ in range(4)]
        A, B, C, C2 = arrs
        pkg_apps.fill_deterministic(A, 3)
        pkg_apps.fill_deterministic(B, 5)
        mapping, outs = {C.name: C2.name}, [(C, C2)]

        def submit(rt):
            return pkg_apps.submit_matmul(rt, A.name, B.name, C.name, N,
                                          bs)
    elif app == "sparselu":
        nb, bs = 4, 3
        arrs = [pkg_apps.ShmArray(nb * nb * bs * bs) for _ in range(2)]
        M, M2 = arrs
        pkg_apps.fill_deterministic(M, 11)
        pkg_apps.fill_deterministic(M2, 11)
        mapping, outs = {M.name: M2.name}, [(M, M2)]

        def submit(rt):
            return pkg_apps.submit_sparselu(rt, M.name, nb, bs)
    else:
        n = 8
        arrs = [pkg_apps.ShmArray(n) for _ in range(6)]
        P, V, A, P2, V2, A2 = arrs
        pkg_apps.fill_deterministic(P, 2)
        pkg_apps.fill_deterministic(P2, 2)
        mapping = {P.name: P2.name, V.name: V2.name, A.name: A2.name}
        outs = [(P, P2), (V, V2)]

        def submit(rt):
            return pkg_apps.submit_nbody(rt, P.name, V.name, A.name, n,
                                         steps=2)
    try:
        with core.ProcessRuntime(num_workers=2, mode=mode) as rt:
            calls = submit(rt)
            rt.taskwait()
        pkg_apps.run_serial(_rename(calls, mapping))
        return ([a.tolist() for a, _ in outs],
                [b.tolist() for _, b in outs])
    finally:
        _drain(arrs)


@pytest.mark.parametrize("app", ["matmul", "sparselu", "nbody"])
def test_host_apps_equal_the_reference_backend(app):
    """The same seeds through the JAX package's backend (forked workers)
    and the port's (fork-server workers): equal values, equal serial
    results, and each equal to its own serial run."""
    jpar, jser = _host_app(japps, jcore, app, "sharded")
    tpar, tser = _host_app(apps, tcore, app, "sharded")
    assert tpar == jpar
    assert tser == jser
    assert tpar == tser


def test_wire_frames_byte_equal_to_reference():
    entries = [(7, pickle.dumps((sum, ((1, 2),)), protocol=4), "alpha"),
               (2 ** 40, b"", ""), (3, b"\x00\xff" * 40, "pp[1,2]")]
    dones = [(7, 1.25, 2.5, DONE_OK, pickle.dumps(3, protocol=4)),
             (9, 0.0, 0.5, DONE_ERROR, b"tb"), (2 ** 33, 3.5, 4.0, 3, b"")]
    assert encode_submit_batch(entries) == \
        jmessages.encode_submit_batch(entries)
    assert encode_done_batch(dones) == jmessages.encode_done_batch(dones)
    assert serial.frame_exec(entries) == jserial.frame_exec(entries)
    assert serial.frame_done(dones) == jserial.frame_done(dones)
    desc = {"arrays": "psm_x", "payload": "psm_y", "payload_size": 10,
            "n": 4, "nedges": 3, "gen": 2}
    assert serial.frame_ctrl(serial.OP_ITER, desc) == \
        jserial.frame_ctrl(jserial.OP_ITER, desc)
    assert serial.frame_ctrl(serial.OP_SHUTDOWN) == \
        jserial.frame_ctrl(jserial.OP_SHUTDOWN)
    assert serial.parse(serial.frame_done(dones)) == \
        jserial.parse(jserial.frame_done(dones))
    # the rings lay the frames out byte for byte alike, wraps included
    from repro.core.procs.rings import ShmRing as JRing
    rings = [ShmRing(capacity=256), JRing(capacity=256)]
    try:
        for r in rings:
            for f in [serial.frame_exec(entries[:1]), b"x" * 90,
                      serial.frame_done(dones[:1])] * 3:
                r.push(f)
                r.pop()
        raw = [bytes(r.shm.buf[:24 + 256]) for r in rings]
        assert raw[0] == raw[1]
    finally:
        for r in rings:
            r.close()
            r.unlink()


@pytest.mark.parametrize("seed", [0, 1, 42, 1234])
def test_seeded_kills_schedule_equals_reference(seed):
    from repro.core.procs.chaos import FaultPlan as JPlan
    sig = lambda p: [(e[0], e[1]) for e in p._kills]
    for workers, total, kills in ((2, 24, 2), (4, 4096, 1), (4, 100, 3)):
        assert sig(chaos.FaultPlan.seeded_kills(seed, workers, total,
                                                kills)) == \
            sig(JPlan.seeded_kills(seed, workers, total, kills))


def test_merged_traces_and_stats_fields_equal_reference():
    """One graph through both packages' process backends with
    trace=True: the same event kinds, the same lifecycle per label; and
    `RuntimeStats` has the reference's fields."""
    evs = {name: _trace_run(core, "processes", mode="sync")
           for name, core in (("jax", jcore), ("torch", tcore))}
    kinds = {k: sorted({e.ev for e in v}) for k, v in evs.items()}
    assert kinds["torch"] == kinds["jax"]

    def per_label(v):
        return sorted((e.label, e.ev) for e in v if e.wd_id >= 0)

    assert per_label(evs["torch"]) == per_label(evs["jax"])
    assert [f.name for f in dataclasses.fields(RuntimeStats)] == \
        [f.name for f in dataclasses.fields(jcore.RuntimeStats)]


# ------------------------------------ start method, watchdog and start-up
def _ppid(pid):
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def _exited(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def test_start_method_is_never_fork():
    with ProcessRuntime(num_workers=2, mode="sync") as rt:
        assert rt.start_method in ("forkserver", "spawn")
        assert rt._ctx.get_start_method() != "fork"
        pids = [p.pid for p in rt._procs]
        # a worker is the fork server's child, not this process's
        assert all(_ppid(pid) != os.getpid() for pid in pids)
        assert sorted(s["pid"] for s in rt.worker_starts) == sorted(pids)
        assert all(s["startup_s"] > 0.0 for s in rt.worker_starts)


def test_worker_outlives_nothing_but_its_runtime():
    """Under the fork server a worker's parent is the server, which
    outlives the runtime: the worker must stay up while the runtime's
    process lives and exit once it is gone."""
    code = textwrap.dedent("""
        import os, sys, time
        from repro_torch.core import ProcessRuntime
        if __name__ == "__main__":
            rt = ProcessRuntime(num_workers=2, mode="sync")
            rt.start()
            pids = [p.pid for p in rt._procs]
            time.sleep(0.5)              # ~100 watchdog periods
            alive = all(p.is_alive() for p in rt._procs)
            print(os.getpid(), alive, *pids, flush=True)
            os._exit(0)                  # no shutdown: the runtime dies
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             p for p in sys.path if p)})
    assert out.returncode == 0, out.stderr
    runtime_pid, alive, *pids = out.stdout.split()
    assert alive == "True"
    deadline = time.time() + JOIN_S
    while not all(_exited(int(p)) for p in pids) and time.time() < deadline:
        time.sleep(0.05)
    assert all(_exited(int(p)) for p in pids), pids


def test_fork_server_preloads_torch_from_a_source_tree():
    """The fork server must hold torch and the port before it forks, also
    when the port is found through a sys.path entry this process added
    (as chip_smoke.py adds src/) and PYTHONPATH is unset: some Python
    releases start the server on the default sys.path, and its workers
    then imported torch each (~9 s apiece on a card's host)."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(tcore.__file__)))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {src!r})
        from multiprocessing import forkserver
        from repro_torch.core import ProcessRuntime
        if __name__ == "__main__":
            with ProcessRuntime(num_workers=1, mode="sync") as rt:
                pid = forkserver._forkserver._forkserver_pid
                with open(f"/proc/{{pid}}/maps") as f:
                    print("libtorch" in f.read(), rt.worker_starts[0]["pid"])
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd="/")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "True", out.stdout


def test_respawned_worker_imports_task_modules_before_ready():
    """(c) a respawned worker is as warm as the one it replaces: it
    imports the modules of every task submitted so far, then says it is
    ready; worker_starts records every start."""
    out = apps.ShmArray(4)
    try:
        plan = chaos.FaultPlan().kill_worker(0, after_tasks=1)
        with ProcessRuntime(num_workers=2, mode="sync", ipc_batch=1,
                            fault_plan=plan) as rt:
            for i in range(4):
                rt.task(chaos.write_index, out.name, i, label=f"w{i}",
                        retries=2)
            rt.taskwait()
            assert "repro_torch.core.procs.chaos" in rt._task_modules
            # phase 35's check at a CPU size: the respawned worker runs
            # a body (least-loaded placement: one probe a worker)
            fresh = {w["pid"] for w in rt.worker_starts[2:]}
            for _ in range(8):
                wds = [rt.task(chaos.worker_probe, "cpu", label=f"p{w}")
                       for w in range(2)]
                rt.taskwait()
                if fresh & {wd.result["pid"] for wd in wds}:
                    break
            assert fresh & {wd.result["pid"] for wd in wds}
            assert all(wd.result["value"] == 30.0 for wd in wds)
        assert out.tolist() == [1.0, 2.0, 3.0, 4.0]
        assert rt.stats.worker_respawns >= 1
        assert len(rt.worker_starts) == 2 + rt.stats.worker_respawns
        assert rt.stats.leaked_shm == []
    finally:
        _drain([out])


def test_device_start_failure_fails_the_run():
    """(f) a worker that cannot use its device reports it at start-up
    and the run raises TaskFailed: nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA: the start-up must fail")
    rt = ProcessRuntime(num_workers=1, mode="sync", device="cuda")
    rt.start()
    rt.task(sum, (1, 2), label="any")
    with pytest.raises(TaskFailed, match="start-up"):
        rt.taskwait()
    rt.shutdown()


# ------------------------------------------------ device arrays on the CPU
def test_device_name_pickles_and_owner_attach_is_the_tensor():
    arr = apps.DeviceArray((3, 4), torch.float64, device="cpu")
    try:
        name = pickle.loads(pickle.dumps(arr.name))
        assert name == arr.name and isinstance(name, apps.DeviceName)
        assert apps._attach(name) is arr.tensor   # the owner's own
        assert arr.tolist() == [0.0] * 12
        arr.tensor[1, 1] = 2.5
        assert arr.tolist()[5] == 2.5
    finally:
        arr.close_unlink()
    with pytest.raises(ValueError, match="cuda"):
        apps.DeviceArray(4, device="meta")


def _stand_in_rebuild(tensor_cls, storage_handle, event_handle):
    """A `rebuild_cuda_tensor` whose signature lacks the send's counter."""


@pytest.mark.parametrize("rebuild", ["installed", "stand-in"])
def test_send_counter_found_by_name(rebuild):
    """A CUDA IPC send's reference counter is found by its argument names
    in the installed torch's `rebuild_cuda_tensor`; a signature without
    them raises instead of giving back the wrong arguments."""
    from torch.multiprocessing import reductions
    if rebuild == "installed":
        fn = reductions.rebuild_cuda_tensor
        names = list(inspect.signature(fn).parameters)
        args = tuple(f"arg {n}" for n in names)
        assert apps.send_counter(fn, args) == ("arg ref_counter_handle",
                                               "arg ref_counter_offset")
    else:
        with pytest.raises(RuntimeError, match="ref_counter_handle or "
                                               "ref_counter_offset"):
            apps.send_counter(_stand_in_rebuild, ("a", "b", "c"))


def _dev(n, seed=None, dtype=torch.float64):
    arr = apps.DeviceArray(n, dtype, device="cpu")
    if seed is not None:
        g = torch.Generator().manual_seed(seed)
        arr.tensor.copy_(torch.rand(arr.tensor.shape, generator=g,
                                    dtype=dtype) - 0.5)
    return arr


def _dev_app(app, rt_factory, dtype=torch.float64):
    """Run one app on CPU device arrays through ``rt_factory()`` and
    serially in this process; returns (parallel, serial) tensors."""
    if app == "matmul":
        N, bs = 3, 4
        A, B = _dev((N * bs) ** 2, 3, dtype), _dev((N * bs) ** 2, 5, dtype)
        C, C2 = _dev((N * bs) ** 2, None, dtype), _dev((N * bs) ** 2, None,
                                                        dtype)
        arrs, mapping, outs = [A, B, C, C2], {C.name: C2.name}, [(C, C2)]

        def submit(rt):
            return apps.submit_matmul(rt, A.name, B.name, C.name, N, bs)
    elif app == "sparselu":
        nb, bs = 4, 5
        M, M2 = _dev(nb * nb * bs * bs, 11, dtype), _dev(nb * nb * bs * bs,
                                                          11, dtype)
        arrs, mapping, outs = [M, M2], {M.name: M2.name}, [(M, M2)]

        def submit(rt):
            return apps.submit_sparselu(rt, M.name, nb, bs)
    else:
        n = 8
        P, P2 = _dev(n, 2, dtype), _dev(n, 2, dtype)
        V, A, V2, A2 = (_dev(n, None, dtype) for _ in range(4))
        arrs = [P, V, A, P2, V2, A2]
        mapping = {P.name: P2.name, V.name: V2.name, A.name: A2.name}
        outs = [(P, P2), (V, V2)]

        def submit(rt):
            return apps.submit_nbody(rt, P.name, V.name, A.name, n, steps=2)
    try:
        with rt_factory() as rt:
            calls = submit(rt)
            rt.taskwait()
        apps.run_serial(_rename(calls, mapping))
        return ([a.tensor.clone() for a, _ in outs],
                [b.tensor.clone() for _, b in outs], rt)
    finally:
        _drain(arrs)


@pytest.mark.parametrize("app", ["matmul", "sparselu", "nbody"])
def test_device_arrays_serial_exact_on_both_backends(app):
    """The tensor bodies through worker processes (attached by name) and
    through threads (the owner's tensors): each bit-identical to a
    serial run of the same kernels in this process."""
    for factory in (lambda: ProcessRuntime(num_workers=2, mode="sharded"),
                    lambda: TaskRuntime(num_workers=2, mode="sharded")):
        par, ser, rt = _dev_app(app, factory)
        for a, b in zip(par, ser):
            assert torch.equal(a, b)
            assert a.abs().sum() > 0


@pytest.mark.parametrize("mode", PROC_MODES)
def test_device_matmul_every_mode(mode):
    par, ser, rt = _dev_app(
        "matmul", lambda: ProcessRuntime(num_workers=2, mode=mode),
        torch.float32)
    assert torch.equal(par[0], ser[0])
    assert rt.stats.tasks_executed == 27
    assert rt.stats.leaked_shm == []


def test_device_kernels_follow_the_host_recurrence():
    """The tensor bodies compute the host kernels' recurrence: float64
    device arrays against the pure-Python kernels on the same values."""
    N, bs = 2, 3
    sh = [apps.ShmArray((N * bs) ** 2) for _ in range(3)]
    dv = [_dev((N * bs) ** 2) for _ in range(3)]
    nb, lbs = 3, 3
    M, dM = apps.ShmArray(nb * nb * lbs * lbs), _dev(nb * nb * lbs * lbs)
    n = 6
    pv = [apps.ShmArray(n) for _ in range(3)]
    dpv = [_dev(n) for _ in range(3)]
    try:
        for s_arr, d_arr, seed in ((sh[0], dv[0], 3), (sh[1], dv[1], 5),
                                   (M, dM, 11), (pv[0], dpv[0], 2)):
            apps.fill_deterministic(s_arr, seed)
            d_arr.tensor.copy_(torch.tensor(s_arr.tolist(),
                                            dtype=torch.float64))
        for names in ([x.name for x in sh], [x.name for x in dv]):
            for i in range(N):
                for j in range(N):
                    for k in range(N):
                        apps.gemm_block(*names, N, bs, i, j, k)
        for mn in (M.name, dM.name):
            for func, args in ((apps.lu0, (0,)), (apps.fwd, (0, 1)),
                               (apps.bdiv, (0, 2)), (apps.bmod, (0, 2, 1))):
                func(mn, nb, lbs, *args)
        for p, v, a in ([x.name for x in pv], [x.name for x in dpv]):
            for i in range(n):
                apps.nbody_force(p, a, n, i)
            for i in range(n):
                apps.nbody_update(p, v, a, i)
        for s_arr, d_arr in ((sh[2], dv[2]), (M, dM), (pv[0], dpv[0]),
                             (pv[1], dpv[1])):
            got = d_arr.tensor.reshape(-1)
            want = torch.tensor(s_arr.tolist(), dtype=torch.float64)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
            assert want.abs().sum() > 0
    finally:
        _drain(sh + dv + [M, dM] + pv + dpv)


def test_device_matmul_replay_ships_no_frames():
    N, bs = 2, 4
    A, B = _dev((N * bs) ** 2, 3), _dev((N * bs) ** 2, 5)
    C, C2 = _dev((N * bs) ** 2), _dev((N * bs) ** 2)
    try:
        with ProcessRuntime(num_workers=2, mode="sharded",
                            replay=True) as rt:
            for _ in range(3):
                calls = apps.submit_matmul(rt, A.name, B.name, C.name, N,
                                           bs)
                rt.taskwait()
        assert rt.stats.ipc_iter[0][0] > 0
        assert [tuple(x) for x in rt.stats.ipc_iter[1:3]] == [(0, 0)] * 2
        for _ in range(3):
            apps.run_serial(_rename(calls, {C.name: C2.name}))
        assert torch.equal(C.tensor, C2.tensor)
    finally:
        _drain([A, B, C, C2])
