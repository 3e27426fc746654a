"""Whole runs at a tiny size on the CPU, the look for a card skipped:
a sound run is correct; the control and each planted fault are not;
the result line has the contract's keys, the compared numbers last."""
import json
import subprocess
import sys

import pytest

import pb_tiny
from port_bench import faults, harness
from port_bench.reference import judge

RUN = str(harness.ROOT / "run.py")


def run(cell, monkeypatch=None, fault=None, **kw):
    ctx = pb_tiny.ctx(cell, **kw)
    drv = harness.load_driver(ctx.cell["driver"])
    if fault:
        name = "make_train_step" if ctx.cell["driver"] == "train" \
            else "make_prefill_step"
        monkeypatch.setattr(drv, name, fault(getattr(drv, name)))
    return drv.run(ctx)


@pytest.mark.parametrize("cell", [pb_tiny.TRAIN, pb_tiny.PREFILL])
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.checks) == set(harness.load_cell(cell)["limits"])
    names = {m["name"] for m in harness.metrics_of(cell, False)}
    assert names <= set(out.e2e)
    assert out.e2e["setup_s"] > 0


@pytest.mark.parametrize("cell,fault", [
    (pb_tiny.TRAIN, faults.unchanged_state),
    (pb_tiny.TRAIN, faults.half_batch),
    (pb_tiny.PREFILL, faults.altered_answer)],
    ids=["unchanged_state", "half_batch", "altered_answer"])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    out = run(cell, monkeypatch, fault)
    assert not out.correct, out.checks


def test_control_is_not_correct_training():
    ctx = pb_tiny.ctx(pb_tiny.TRAIN, dtype="bfloat16")
    drv = harness.load_driver("train")
    ref = drv.reference_readings(ctx)
    ctl = drv.reference_readings(ctx, precision="fp8")
    checks = harness.verdict(judge.train_numbers(ctl, ref, "cpu"),
                             ctx.cell["limits"])
    assert not all(v <= lim for v, lim in checks.values()), checks


def test_control_is_not_correct_prefill():
    ctx = pb_tiny.ctx(pb_tiny.PREFILL, dtype="bfloat16")
    drv = harness.load_driver("prefill")
    p = drv.Prefiller(ctx, drv.make_prefill_step)
    prompts = p.prompts(0)
    del p
    want, _ = drv.reference_logits(ctx, prompts)
    ctl, _ = drv.reference_logits(ctx, prompts, "fp8")
    checks = harness.verdict(
        judge.prefill_numbers(judge.row_errors(ctl, want)),
        ctx.cell["limits"])
    assert not all(v <= lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("cell", [pb_tiny.TRAIN, pb_tiny.PREFILL])
def test_result_line(cell):
    import importlib.util
    spec = importlib.util.spec_from_file_location("pb_run", RUN)
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)
    from port_bench.peaks import PEAKS
    bench = harness.benchmark()
    for trace in (False, True):
        out = run(cell, trace=trace)
        line = run_mod.report(out, harness.load_cell(cell), trace, bench,
                              "cpu", "H100 SXM", PEAKS["H100 SXM"], None)
        text = json.dumps(line, allow_nan=False)
        assert list(json.loads(text))[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            # no kernel ran on the CPU: the device readers find nothing
            assert not {k for k in line["metrics"] if "roofline" in k}
        else:
            assert "setup_s" in line["metrics"]


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, RUN, "--workload", pb_tiny.TRAIN,
                           "--seed", str(2**31 + 3), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is visible")
    assert proc.returncode == 2 and proc.stdout == ""
