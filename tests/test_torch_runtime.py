"""The port's threaded task runtime (`repro_torch.core`) against the JAX
package's (`repro.core`) on the CPU: the same graphs through both, for
each dependence organization, live and under record-and-replay; scopes
with weighted-fair admission, per-scope failure isolation and deadline
expiry; tracing, the metrics plane and the port's viewers.

Only deterministic quantities are compared: results, per-region orders
that the dependences fix, task and admission counts. Message, steal and
replay-hit counts depend on thread timing and are never asserted."""
import json
import threading
import time
from collections import Counter

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.analysis import metricsview, traceview

CORES = {"jax": jcore, "torch": tcore}
MODES = ("sync", "dast", "ddast", "sharded")
EPOCHS = 3
NB, BS = 4, 8                   # blocked matmul: 4 x 4 blocks of 8 x 8
NPAR, NCHILD, NREG = 3, 6, 3    # nested graph
CHILD_MODES = ("out", "in", "inout", "in", "in", "inout")
JOIN_S = 30.0


def _spin(n=200):
    s = 0
    for i in range(n):
        s += i
    return s


def _gemm(c, a, b):
    c += a @ b


def _blocks(seed):
    rng = np.random.RandomState(seed)
    m = rng.standard_normal((NB * BS, NB * BS)).astype(np.float32)
    return m, [[m[i * BS:(i + 1) * BS, j * BS:(j + 1) * BS].copy()
                for j in range(NB)] for i in range(NB)]


def run_matmul(core, mode, replay, trace=False, metrics=False):
    """C = A @ B by blocks, `EPOCHS` times: each (i, j) block is an INOUT
    chain over k. Returns (the product of every epoch, the runtime)."""
    am, a = _blocks(0)
    bm, b = _blocks(1)
    c = [[np.zeros((BS, BS), np.float32) for _ in range(NB)]
         for _ in range(NB)]
    out = []
    with core.TaskRuntime(num_workers=3, mode=mode, replay=replay,
                          trace=trace, metrics=metrics,
                          metrics_interval_s=1e-4) as rt:
        for _ in range(EPOCHS):
            for row in c:
                for blk in row:
                    blk[...] = 0.0
            for i in range(NB):
                for j in range(NB):
                    for k in range(NB):
                        rt.task(_gemm, c[i][j], a[i][k], b[k][j],
                                deps=[(("A", i, k), "in"),
                                      (("B", k, j), "in"),
                                      (("C", i, j), "inout")],
                                label=f"g{i}{j}{k}")
            rt.taskwait()
            out.append(np.block(c).copy())
    return out, rt, am @ bm


def _canonical(log):
    """A region's log with each run of consecutive readers sorted: the
    dependences order every writer against everything, and readers
    between two writers in any order."""
    out, reads = [], []
    for entry in log:
        if entry[0] == "r":
            reads.append(entry)
            continue
        if reads:
            out.append(tuple(sorted(reads)))
            reads = []
        out.append(entry)
    if reads:
        out.append(tuple(sorted(reads)))
    return out


def run_nested(core, mode, replay, trace=False):
    """Parents that each create `NCHILD` children with IN / OUT / INOUT
    regions and wait for them; children append to per-region logs.
    Returns (each epoch's canonical logs, the runtime)."""
    epochs = []
    with core.TaskRuntime(num_workers=3, mode=mode, replay=replay,
                          trace=trace) as rt:
        for _ in range(EPOCHS):
            logs = {(p, r): [] for p in range(NPAR) for r in range(NREG)}
            value = {}

            def child(p, c):
                own = (p, c % NREG)
                if CHILD_MODES[c] == "in":
                    logs[own].append(("r", f"c{p}.{c}", value.get(own)))
                else:
                    logs[own].append(("w", f"c{p}.{c}"))
                    value[own] = f"c{p}.{c}"
                nxt = (p, (c + 1) % NREG)
                logs[nxt].append(("r", f"c{p}.{c}", value.get(nxt)))

            def parent(p):
                for c in range(NCHILD):
                    rt.task(child, p, c,
                            deps=[(("R", p, c % NREG), CHILD_MODES[c]),
                                  (("R", p, (c + 1) % NREG), "in")],
                            label=f"c{p}.{c}")
                rt.taskwait()

            for p in range(NPAR):
                rt.task(parent, p, deps=[(("P", p % 2), "inout")],
                        label=f"p{p}")
            rt.taskwait()
            epochs.append({k: _canonical(v) for k, v in logs.items()})
    return epochs, rt


# ------------------------------------------------------------ graphs
@pytest.mark.parametrize("replay", [False, True], ids=["live", "replay"])
@pytest.mark.parametrize("mode", MODES)
def test_blocked_matmul_matches_reference_and_numpy(mode, replay):
    got = {name: run_matmul(core, mode, replay)
           for name, core in CORES.items()}
    (jout, jrt, want), (tout, trt, _) = got["jax"], got["torch"]
    for j, t in zip(jout, tout):
        # the INOUT chain fixes each block's order of accumulation
        np.testing.assert_array_equal(t, j)
        np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-4)
    n = EPOCHS * NB ** 3
    assert trt.stats.tasks_executed == jrt.stats.tasks_executed == n
    assert not any(th.is_alive() for th in trt._threads)


@pytest.mark.parametrize("replay", [False, True], ids=["live", "replay"])
@pytest.mark.parametrize("mode", MODES)
def test_nested_graph_region_order_matches_reference(mode, replay):
    jlogs, jrt = run_nested(jcore, mode, replay)
    tlogs, trt = run_nested(tcore, mode, replay)
    assert tlogs == jlogs
    # each parent's children run in its creation order on every region
    # a child writes
    for epoch in tlogs:
        for (p, r), log in epoch.items():
            writers = [e[1] for e in log if e and e[0] == "w"]
            assert writers == sorted(writers)
    n = EPOCHS * NPAR * (NCHILD + 1)
    assert trt.stats.tasks_executed == jrt.stats.tasks_executed == n


# ------------------------------------------------------------ scopes
def _two_tenants(core, from_threads):
    """Tenant "a" (weight 2) and tenant "b" (weight 1, max_inflight 2),
    submitting from the main thread or each from a client thread of its
    own. Returns (per-scope admission counters, the runtime)."""
    counts = {"a": 12, "b": 6}
    with core.TaskRuntime(num_workers=2, mode="ddast",
                          num_clients=2) as rt:
        adm = {}

        def tenant(name):
            sc = rt.open_scope(name, weight=2.0 if name == "a" else 1.0,
                               max_inflight=2 if name == "b" else None)
            for i in range(counts[name]):
                sc.task(_spin, deps=[(("x", i % 3), "inout")],
                        label=f"{name}{i}")
            sc.taskwait()
            adm[name] = rt.placement.scope_admission(sc.scope_id)

        if from_threads:
            ths = [threading.Thread(target=tenant, args=(n,))
                   for n in counts]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=JOIN_S)
                assert not th.is_alive()
        else:
            for n in counts:
                tenant(n)
    return adm, rt


@pytest.mark.parametrize("from_threads", [False, True],
                         ids=["main", "clients"])
def test_scopes_fair_admission_counts_match_reference(from_threads):
    jadm, jrt = _two_tenants(jcore, from_threads)
    tadm, trt = _two_tenants(tcore, from_threads)
    for name, n in (("a", 12), ("b", 6)):
        for key in ("admitted", "weight", "drained"):
            assert tadm[name][key] == jadm[name][key], (name, key)
        assert tadm[name]["admitted"] == n
        assert trt.stats.scopes[name]["tasks"] == \
            jrt.stats.scopes[name]["tasks"] == n
        assert trt.stats.scopes[name]["weight"] == \
            jrt.stats.scopes[name]["weight"]
    assert tadm["a"]["weight"] == 2.0


def _boom(msg):
    raise RuntimeError(msg)


@pytest.mark.parametrize("core", CORES.values(), ids=CORES.keys())
def test_scope_failure_raises_only_from_its_own_wait(core):
    rt = core.TaskRuntime(num_workers=2, num_clients=2)
    rt.start()
    a = rt.open_scope("a")
    b = rt.open_scope("b")
    a.task(_boom, "boomA", label="bad")
    for i in range(4):
        b.task(_spin, label=f"b{i}")
    b.taskwait()                         # the other tenant: no raise
    rt.taskwait()                        # the root: no raise either
    with pytest.raises(core.TaskFailed, match="boomA"):
        a.taskwait()
    rt.shutdown()                        # the error was consumed
    assert rt.stats.tasks_poisoned == 1


@pytest.mark.parametrize("core", CORES.values(), ids=CORES.keys())
def test_scope_deadline_past_due_expires(core):
    rt = core.TaskRuntime(num_workers=2, num_clients=1)
    rt.start()
    sc = rt.open_scope("late", deadline=1e-3)
    time.sleep(0.01)
    for i in range(5):
        sc.task(_spin, label=f"l{i}")
    with pytest.raises(core.ScopeExpired, match="deadline"):
        sc.taskwait()
    rt.shutdown()
    assert rt.stats.scopes_expired == 1
    assert rt.stats.scopes["late"]["expired"].startswith("deadline")


@pytest.mark.parametrize("core", CORES.values(), ids=CORES.keys())
def test_processes_backend_dispatches(core):
    rt = core.TaskRuntime(num_workers=2, backend="processes")
    assert isinstance(rt, core.ProcessRuntime)
    assert (rt.num_workers, rt.mode) == (2, "sharded")
    with pytest.raises(ValueError, match="backend"):
        core.TaskRuntime(num_workers=2, backend="gpu")


# ------------------------------------------------- tracing and metrics
LIFECYCLE = ("created", "start", "end")


def _per_task(events):
    per = {}
    for e in events:
        if e.wd_id >= 0 and e.ev in LIFECYCLE:
            per.setdefault(e.label, Counter())[e.ev] += 1
    return per


@pytest.mark.parametrize("graph", ["matmul", "nested"])
def test_trace_events_match_reference(graph):
    run = run_matmul if graph == "matmul" else run_nested
    rts = {name: run(core, "ddast", False, trace=True)[1]
           for name, core in CORES.items()}
    jst, tst = rts["jax"].stats, rts["torch"].stats
    assert tst.trace_dropped == jst.trace_dropped == 0
    tper, jper = _per_task(tst.events), _per_task(jst.events)
    assert tper == jper
    assert all(c["created"] == c["end"] == EPOCHS for c in tper.values())
    # the task lifecycle and the quiescence boundary are in every run;
    # steals and message events depend on timing, so only these kinds
    # are compared
    kinds = {"created", "deps_resolved", "ready", "start", "end",
             "quiesce"}
    assert kinds <= {e.ev for e in tst.events}
    assert {e.ev for e in tst.events} & kinds == \
        {e.ev for e in jst.events} & kinds


def test_metrics_snapshot_keys_match_reference():
    rts = {name: run_matmul(core, "ddast", False, metrics=True)[1]
           for name, core in CORES.items()}
    jm, tm = rts["jax"].stats.metrics, rts["torch"].stats.metrics
    assert set(tm) == set(jm)
    assert set(tm["gauges"]) == set(jm["gauges"])
    assert set(tm["sampler"]) == set(jm["sampler"])
    # every task started and finished once, on both runtimes
    n = EPOCHS * NB ** 3
    for m in (tm, jm):
        assert m["counters"]["tasks_finished"]["total"] == n
        assert m["task_latency"]["count"] == n


def test_metrics_read_while_run_in_flight():
    """`rt.metrics()` from another thread while workers record: every read
    succeeds and the finished count never goes back."""
    stop = threading.Event()
    seen, errors = [], []
    with tcore.TaskRuntime(num_workers=2, mode="sharded", metrics=True,
                           metrics_interval_s=1e-4) as rt:
        def reader():
            while not stop.is_set():
                try:
                    seen.append(rt.metrics()["counters"]
                                ["tasks_finished"]["total"])
                except Exception as e:     # noqa: BLE001 - recorded
                    errors.append(e)

        th = threading.Thread(target=reader)
        th.start()
        try:
            for i in range(200):
                rt.task(time.sleep, 1e-5, label=f"t{i}")
            rt.taskwait()
        finally:
            stop.set()
            th.join(timeout=JOIN_S)
    assert not th.is_alive()
    assert not errors, errors[:3]
    assert seen and seen == sorted(seen)
    assert rt.stats.metrics["counters"]["tasks_finished"]["total"] == 200


def test_port_viewers_read_port_files(tmp_path):
    _, rt, _ = run_matmul(tcore, "sharded", False, trace=True,
                          metrics=True)
    tr = tmp_path / "run.trace"
    tcore.save_trace(str(tr), rt.stats.events, time_unit="s")
    mj = tmp_path / "metrics.json"
    from repro_torch.core.metrics import save_metrics
    save_metrics(str(mj), rt.stats.metrics)
    out = tmp_path / "out.json"
    assert traceview.main([str(tr), "-o", str(out), "--detect",
                           "--counters", str(mj)]) == 0
    doc = json.loads(out.read_text())
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(slices) == rt.stats.tasks_executed
    assert any(e["ph"] == "i" and e["name"] == "quiesce"
               for e in doc["traceEvents"])
    prom = tmp_path / "metrics.prom"
    assert metricsview.main([str(mj), "-o", str(prom)]) == 0
    text = prom.read_text()
    assert "repro_tasks_finished_total" in text
    perf = tmp_path / "counters.json"
    assert metricsview.main([str(mj), "-o", str(perf), "--perfetto"]) == 0
    assert json.loads(perf.read_text())["traceEvents"]
