"""The port's spans and counters (`core.trace.span`, `ThreadClock`,
`TaskRuntime.idle_polls`) on the CPU, on a tiny MoE configuration: a
train step's phases and each MoE layer's route, dispatch and combine are
profiler ranges only while a profiler records, and change no bit of the
step; the step clock and the runtime's idle polls count. One test runs
on the card (marked `card`; skips without one): each kernel wrapper's
range once a call, the autograd device thread's included."""
import collections
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.core import TaskRuntime  # noqa: E402
from repro_torch.core.trace import spans  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_train_step)

ARCH = "qwen2-moe-a2.7b"
TRAIN = ("port.train.forward", "port.train.backward", "port.train.clip",
         "port.train.adamw")
MOE = ("port.moe.route", "port.moe.dispatch", "port.moe.combine")


def _trainer(cfg, device="cpu", seed=0):
    model = get_model(cfg, device)
    params = model.init_params(torch.Generator(device).manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    batch = {"tokens": tokens[:, :-1].to(device),
             "labels": tokens[:, 1:].to(device)}
    return make_train_step(model, TrainConfig()), params, \
        init_opt_state(params), batch


def _port_ranges(prof):
    """The profiled host `port.*` ranges as (start, end, name), by start
    (with CUDA activity the profiler also lists each range's projection
    on the device, which is left out)."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("port.")
                  and e.device_type == DeviceType.CPU)


def test_train_step_records_its_phases_and_each_moe_layer():
    cfg = tiny_config(ARCH)
    step, params, opt, batch = _trainer(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, batch)
    ranges = _port_ranges(prof)
    phases = [r for r in ranges if r[2].startswith("port.train.")]
    assert [name for _, _, name in phases] == list(TRAIN)
    for (_, end, _), (start, _, _) in zip(phases, phases[1:]):
        assert end <= start
    layers = sum(b.ffn == "moe" for b in cfg.pattern) * cfg.repeats
    assert layers >= 2
    fwd0, fwd1 = phases[0][:2]
    moe = [r for r in ranges if r[2].startswith("port.moe.")]
    assert [name for _, _, name in moe] == list(MOE) * layers
    assert all(fwd0 <= a and b <= fwd1 for a, b, _ in moe)


def test_span_builds_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert spans.span("port.x") is spans.span("port.y")
    step, params, opt, batch = _trainer(tiny_config(ARCH))
    step(params, opt, batch)                  # no profiler: no range
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="port.x"):
            spans.span("port.x")


def test_profiler_changes_no_bit_of_the_step():
    cfg = tiny_config(ARCH)
    out = []
    for profiled in (False, True):
        step, params, opt, batch = _trainer(cfg)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                _, _, metrics = step(params, opt, batch)
        else:
            _, _, metrics = step(params, opt, batch)
        out.append((metrics["loss"].clone(),
                    {n: p.detach().clone()
                     for n, p in params.named_parameters()}))
    (loss_a, p_a), (loss_b, p_b) = out
    assert torch.equal(loss_a, loss_b)
    assert p_a.keys() == p_b.keys()
    assert all(torch.equal(p_a[n], p_b[n]) for n in p_a)


def test_step_clock_counts_calls_with_wall_at_least_cpu():
    step, params, opt, batch = _trainer(tiny_config(ARCH))
    assert step.clock.read() == (0, 0.0, 0.0)
    for _ in range(2):
        step(params, opt, batch)
    calls, wall, cpu = step.clock.read()
    assert calls == 2
    assert wall >= cpu >= 0.0 and wall > 0.0


@pytest.mark.parametrize("trace", [False, True])
def test_idle_polls_grow_while_the_runtime_idles(trace):
    rt = TaskRuntime(num_workers=2, mode="ddast", trace=trace)
    rt.start()
    try:
        deadline = time.monotonic() + 10.0
        while (min(rt.idle_polls.per_slot[:2]) < 20 or
               (trace and not rt.stats.trace)) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        polls = list(rt.idle_polls.per_slot)
    finally:
        rt.shutdown()
    assert min(polls[:2]) >= 20            # each worker polled
    assert polls[2:] == [0, 0]             # the main and overflow slots
    assert rt.idle_polls.total >= sum(polls)
    # a traced runtime keeps its (t, in_graph, ready) samples; an untraced
    # one takes none
    assert bool(rt.stats.trace) == trace


KERNEL_SPANS = {
    "port.kernel.moe_gemm": ("moe_gemm", "moe_gemm"),
    "port.kernel.moe_gemm_dx": ("moe_gemm", "moe_gemm_bwd_dx"),
    "port.kernel.moe_gemm_dw": ("moe_gemm", "moe_gemm_bwd_dw"),
    "port.kernel.flash_fwd": ("flash_attention", "flash_attention"),
    "port.kernel.flash_bwd": ("flash_attention", "flash_attention_bwd"),
    "port.kernel.sel_scan": ("ssm_scan", "selective_scan"),
    "port.kernel.sel_scan_bwd": ("ssm_scan", "selective_scan_bwd"),
}


@pytest.mark.card
def test_kernel_spans_match_the_wrappers_launches_on_the_card():
    """One bf16 step of tiny Jamba with its whole period (attention, Mamba
    and MoE layers) under the profiler: each `port.kernel.*` range count
    equals its wrapper's launch count (the flash backward's over its
    launches a call), and the backward's ranges, entered on the autograd
    engine's device thread, are recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib
    fns = {}
    for name, (mod, fn) in KERNEL_SPANS.items():
        fns[name] = getattr(importlib.import_module(
            f"repro_torch.kernels.{mod}"), fn)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    arch = "jamba-v0.1-52b"
    cfg = tiny_config(arch).scaled(pattern=get_config(arch).pattern,
                                   repeats=1, dtype="bfloat16")
    step, params, opt, batch = _trainer(cfg, "cuda")
    step(params, opt, batch)                  # builds and loads the kernels
    torch.cuda.synchronize()
    before = {n: f.launches for n, f in fns.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    got = collections.Counter(r[2] for r in _port_ranges(prof))
    want = {n: fns[n].launches - before[n] for n in fns}
    want["port.kernel.flash_bwd"] //= fa.BWD_LAUNCHES[torch.bfloat16]
    assert {n: got[n] for n in KERNEL_SPANS} == want
    assert min(want.values()) >= 1
    assert got["port.train.backward"] == 1
