"""The program's spans read from a trace (`progtrace`): operations by the
span open at their launch, idle gaps by the program's spans, the six
readers on hand-made records; and the probe's cells at a tiny size on the
CPU."""
import pytest

import pb_tiny
from port_bench import devtrace, harness, progtrace


def ev(name, ts, dur, cat="kernel", tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "pid": 7 if cat in devtrace.DEVICE_CATS else 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur, tid=1):
    return ev(name, ts, dur, "user_annotation", tid)


def launch(ts, corr, tid=1):
    return ev("cudaLaunchKernel", ts, 2, "cuda_runtime", tid, corr)


EVENTS = [
    span("pb.window", 0, 200),
    span("pb.step_call", 0, 150),
    span("port.train.forward", 10, 40),
    span("port.moe.dispatch", 11, 3),
    span("port.train.backward", 50, 50),
    span("port.train.adamw", 100, 40),
    # the autograd engine's thread: a kernel wrapper's span and a launch
    # while the stepping thread sits in the backward span
    span("port.kernel.moe_gemm_dx", 58, 4, tid=2),
    # a worker that launched nothing: its span names no gap
    span("port.rt.worker", 0, 200, tid=3),
    launch(12, 1), launch(60, 2, tid=2), launch(105, 3),
    ev("cuLaunchKernel", 109, 1, "cuda_driver", 1, 4),
    ev("moe_gemm_wgmma_kernel", 15, 10, corr=1),
    ev("moe_gemm_dx_wgmma_kernel", 62, 18, corr=2),
    ev("vectorized_elementwise_kernel", 108, 4, corr=3),
    ev("Memcpy DtoD", 113, 5, "gpu_memcpy", corr=4),
    ev("unlaunched_kernel", 190, 20),            # no launch in the trace
]


def test_operations_belong_to_the_span_open_at_their_launch():
    pt = progtrace.reduce(EVENTS)
    assert progtrace.launched_in(pt, ("port.train.forward",)) == \
        (pytest.approx(10e-6), 1)
    # launched on thread 2 while thread 1 was in the backward span
    assert progtrace.launched_in(pt, ("port.train.backward",)) == \
        (pytest.approx(18e-6), 1)
    assert progtrace.launched_in(pt, ("port.kernel.moe_gemm_dx",)) == \
        (pytest.approx(18e-6), 1)
    # a runtime launch and a driver launch, both inside AdamW
    assert progtrace.launched_in(pt, progtrace.OPTIMIZER) == \
        (pytest.approx(9e-6), 2)
    assert progtrace.launched_in(pt, progtrace.STEP_PHASES)[1] == 4
    assert progtrace.launched_in(pt, ("pb.step_call",)) == \
        (pytest.approx(37e-6), 4)
    assert progtrace.host_seconds(pt, progtrace.OPTIMIZER) == \
        pytest.approx(40e-6)
    # the window, the operations and busy time are devtrace's own
    old = devtrace.reduce_events(EVENTS)
    assert (pt.profile.window_s, pt.profile.busy_s, pt.profile.ops) == \
        (old.window_s, old.busy_s, old.ops)
    assert [s for _, s in pt.profile.gaps] == [s for _, s in old.gaps]


def test_gaps_are_named_by_the_innermost_span_of_a_launching_thread():
    pt = progtrace.reduce(EVENTS)
    names = [n for n, _, _ in pt.gaps]
    # [0,15] [25,62] [80,108] [112,113] [118,190]
    assert names == ["pb.step_call", "port.train.forward",
                     "port.train.backward", "port.train.adamw",
                     "between calls"]
    # the harness's reduction names the AdamW gap by its own span
    assert [n for n, _ in devtrace.reduce_events(EVENTS).gaps][3] == \
        "pb.step_call"
    owners = progtrace.idle_owners(pt, "pb.step_call")
    assert owners == {"pb.step_call": pytest.approx(15e-6),
                      "port.train.forward": pytest.approx(37e-6),
                      "port.train.backward": pytest.approx(28e-6),
                      "port.train.adamw": pytest.approx(1e-6)}
    assert "all 1 gaps in port.train.adamw" in [
        g[0] for g in pt.profile.breakdown()["idle_gaps"]]


def test_a_worker_span_names_no_gap():
    pt = progtrace.reduce(EVENTS)
    assert all(n != "port.rt.worker" for n, _, _ in pt.gaps)
    # the same span on the launching thread does name it
    moved = [dict(e, tid=1) if e["name"] == "port.rt.worker" else e
             for e in EVENTS]
    assert progtrace.reduce(moved).gaps[-1][0] == "port.rt.worker"


RECORD = {"profiled_units": 2, "window": {"steps": 10},
          "counters": {"step_clock": [10, 2.0, 0.5], "idle_polls": 1000}}


@pytest.mark.parametrize("metric,value", [
    ("optimizer_device_ms.train", 9e-3 / 2),
    ("optimizer_host_ms.train", 40e-3 / 2),
    ("optimizer_launches.train", 2 / 2),
    ("step_offcpu_pct.train", 75.0),
    ("rt_idle_polls.train", 100.0),
    ("moe_dispatch_ms.prefill", 10e-3 / 2)])
def test_each_reader_on_a_record_and_none_without_it(metric, value):
    read = harness.load_metric(metric).read
    rec = dict(RECORD, program_trace=progtrace.reduce(EVENTS))
    assert read(rec) == pytest.approx(value)
    assert read({"profiled_units": 2}) is None
    # the parent's program: no port.* span, no counter
    parent = [e for e in EVENTS if not e["name"].startswith("port.")]
    assert read({"profiled_units": 2, "window": {"steps": 10},
                 "program_trace": progtrace.reduce(parent)}) is None


def test_device_readers_find_nothing_without_device_operations():
    host_only = [e for e in EVENTS if e["cat"] not in devtrace.DEVICE_CATS]
    rec = dict(RECORD, program_trace=progtrace.reduce(host_only))
    assert progtrace.launched_ms(rec, progtrace.OPTIMIZER) is None
    assert progtrace.launches(rec, progtrace.OPTIMIZER) is None
    assert progtrace.host_ms(rec, progtrace.OPTIMIZER) == \
        pytest.approx(20e-3)


def _probe():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "pb_spans_probe", harness.ROOT / "spans_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_train_cell_on_the_cpu():
    ctx = pb_tiny.ctx(pb_tiny.TRAIN, seconds=0.3, trace=True)
    out = _probe().train(ctx, harness, progtrace, devtrace)
    m = out["metrics"]
    assert 0.0 <= m["step_offcpu_pct.train"] <= 100.0
    assert m["rt_idle_polls.train"] >= 0.0
    assert m["optimizer_host_ms.train"] > 0.0
    # no kernel ran on the CPU: the device readers find nothing
    assert m["optimizer_device_ms.train"] is None
    assert m["optimizer_launches.train"] is None
    layers = sum(f == "moe" for _, f in ctx.arch.layers)
    counts = out["span_counts"]
    assert [counts[n] for n in progtrace.STEP_PHASES] == [2] * 4
    assert [counts[n] for n in progtrace.MOE] == [2 * layers] * 3
    assert out["counters"]["step_clock"][0] >= 1


def test_probe_prefill_cell_on_the_cpu():
    ctx = pb_tiny.ctx(pb_tiny.PREFILL, trace=True)
    out = _probe().prefill(ctx, harness, progtrace, devtrace)
    layers = sum(f == "moe" for _, f in ctx.arch.layers)
    assert [out["span_counts"][n] for n in progtrace.MOE] == \
        [2 * layers] * 3
    assert out["metrics"]["moe_dispatch_ms.prefill"] is None
