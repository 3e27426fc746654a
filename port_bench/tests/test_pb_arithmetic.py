"""The window's statistics, the work arithmetic and the trace reduction
on hand-counted cases."""
import statistics

import pytest

from port_bench import devtrace, readers, stats, work
from port_bench.arch import Arch
from port_bench.peaks import PEAKS, peaks_for

P = PEAKS["H100 SXM"]


def test_rate_is_all_work_over_the_whole_window():
    assert stats.rate(10 * 8192, 4.0) == 20480.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_over_every_sample():
    lat = list(range(1, 201))                      # 200 calls, 1..200 ms
    # inclusive: (n - 1) * 0.95 = 189.05 -> 190 + 0.05 * (191 - 190)
    assert stats.percentile(lat, 95) == pytest.approx(190.05)
    slow = lat[:-10] + [1000.0] * 10               # ten stalls beyond it
    assert stats.percentile(slow, 95) > 190
    assert statistics.median(slow) == statistics.median(lat)


def test_peaks_by_device_name():
    assert peaks_for("NVIDIA H100 80GB HBM3")[0] == "H100 SXM"
    assert peaks_for("NVIDIA H100 PCIe")[0] == "H100 PCIe"


def test_grouped_gemm_counts_routed_rows_and_reached_experts():
    # 3 experts, one empty: 100 + 28 rows, d_in 16, d_out 8, bf16
    t, by = work.grouped_gemm([100, 0, 28], 16, 8, 2, P)
    flops = 2 * 128 * 16 * 8
    nbytes = 2 * (128 * 16 + 2 * 16 * 8 + 128 * 8)
    assert t == max(flops / P.bf16_fps, nbytes / P.hbm_bps)
    assert by == "bytes"
    # the empty expert's weights count nothing: the same as without it
    assert work.grouped_gemm([100, 28], 16, 8, 2, P)[0] == t
    # dw writes each reached expert's gradient once
    t_dw, _ = work.grouped_gemm_dw([100, 0, 28], 16, 8, 2, P)
    assert t_dw == max(flops / P.bf16_fps, nbytes / P.hbm_bps)


def test_moe_layer_launches():
    assert len(work.moe_layer([4, 4], 8, 16, 2, P, backward=False)) == 3
    assert len(work.moe_layer([4, 4], 8, 16, 2, P, backward=True)) == 9


def test_live_causal_pairs():
    assert work.live_pairs(1, 1, 4) == 10
    assert work.live_pairs(2, 3, 4, causal=False) == 2 * 3 * 16
    assert work.live_pairs(1, 1, 5, window=2) == 3 + 3 * 2


def test_attention_bounds_by_hand():
    b, s, nq, nkv, hd = 1, 4096, 32, 8, 128
    pairs = 32 * 4096 * 4097 // 2
    t, by = work.attention_fwd(b, s, nq, nkv, hd, 2, P)
    assert by == "operations"
    assert t == pytest.approx(4 * hd * pairs / P.bf16_fps)
    tb, _ = work.attention_bwd(b, s, nq, nkv, hd, 2, P)
    assert tb == pytest.approx(10 * hd * pairs / P.bf16_fps)


def test_selective_scan_bound_splits_the_exponentials():
    t, by = work.selective_scan(1, 4096, 8192, 16, 2, P)
    exps = 4096 * 8192 * 16
    # a share p of the exponentials on the FMA pipes so that both finish
    # together; chip_smoke.py's bound at this shape was 0.0789 ms
    p = (exps * P.f32_fps - 6 * exps * P.sfu_eps) / (
        exps * P.f32_fps + 10 * exps * P.sfu_eps)
    assert (1 - p) * exps / P.sfu_eps == pytest.approx(
        (6 * exps + 10 * p * exps) / P.f32_fps)
    assert t == pytest.approx((1 - p) * exps / P.sfu_eps)
    assert t == pytest.approx(0.0789e-3, rel=2e-3)
    assert by == "operations"


def test_model_flops():
    assert work.model_flops(10, 100, train=True) == 6000
    assert work.model_flops(10, 100, train=False) == 2000


def test_active_parameters_of_the_cells():
    assert Arch.load("qwen2-moe-a2.7b").active_param_count() == 966_778_880
    assert Arch.load("jamba-v0.1-52b").active_param_count() == 6_264_504_320


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def synthetic_profile():
    return devtrace.reduce_events([
        ev("pb.window", 0, 100, "user_annotation"),
        ev("pb.step_call", 0, 60, "user_annotation"),
        ev("pb.loss_read", 60, 40, "user_annotation"),
        ev("moe_gemm_wgmma_kernel", 10, 20),
        ev("flash_fwd_mma_kernel", 25, 15),         # overlaps the first
        ev("elementwise_kernel", 70, 10),
        ev("late_kernel", 95, 20),                  # clipped at the end
        ev("cudaLaunchKernel", 0, 5, "cuda_runtime"),
    ])


def test_trace_reduction_busy_union_and_named_gaps():
    prof = synthetic_profile()
    assert prof.window_s == pytest.approx(100e-6)
    assert prof.busy_s == pytest.approx((40 - 10 + 10 + 5) * 1e-6)
    gaps = dict((n, s) for n, s in sorted(prof.gaps, key=lambda g: g[1]))
    assert sorted(prof.gaps, key=lambda g: -g[1])[0] == \
        ("pb.step_call", pytest.approx(30e-6))
    assert gaps["pb.loss_read"] == pytest.approx(15e-6)
    bd = prof.breakdown()
    assert bd["device_ops"][0] == ["moe_gemm_wgmma_kernel",
                                   pytest.approx(20e-6)]
    # [0,10] and [40,70] in the step call, [80,95] in the loss's read
    assert bd["idle_gaps"][:2] == [["all 2 gaps in pb.step_call",
                                     pytest.approx(40e-6)],
                                    ["all 1 gaps in pb.loss_read",
                                     pytest.approx(15e-6)]]
    assert bd["idle_gaps"][2] == ["one gap in pb.step_call",
                                  pytest.approx(30e-6)]
    assert len(bd["idle_gaps"]) == 5


def record(prof, units=1, rows=None):
    a = Arch.load("jamba-v0.1-52b")
    return {"arch": a, "peaks": P, "profile": prof, "profiled_units": units,
            "cell": {"traffic": {"batch": 1, "seq_len": 4096}},
            "moe_rows": rows or [{1: [512] * 16}],
            "window": {"wall_s": 2.0, "tokens": 40960}}


def test_readers_on_a_synthetic_profile():
    prof = synthetic_profile()
    rec = record(prof)
    assert readers.device_idle(rec) == pytest.approx(55.0)
    one_layer = work.add(work.moe_layer([512] * 16, 4096, 14336, 2, P,
                                        False))[0]
    assert readers.moe_gemm(rec, backward=False) == pytest.approx(
        100 * one_layer / 20e-6)
    mfu = 2 * a_params() * 40960 / 2.0 / P.bf16_fps * 100
    assert readers.mfu(rec, train=False) == pytest.approx(mfu)
    # no scan kernel in the profile: nothing to read, never 0
    assert readers.sel_scan(rec) is None


def a_params():
    return Arch.load("jamba-v0.1-52b").active_param_count()


def test_roofline_counts_work_not_capacity():
    """Skipping empty slots lowers the time, never raises the bound:
    the bound follows the routed rows only."""
    prof = synthetic_profile()
    full = readers.moe_gemm(record(prof, rows=[{1: [640] * 16}]), False)
    routed = readers.moe_gemm(record(prof, rows=[{1: [512] * 16}]), False)
    assert routed < full


def test_elementwise_groups_first_match_wins():
    from port_bench import harness
    m = harness.load_metric("elementwise_ms.train")
    assert m.group("void at::native::elementwise_kernel<...>") == \
        "elementwise and copies"
    assert m.group("moe_gemm_dx_wgmma_kernel") == "moe_gemm backward"
    assert m.group("direct_copy_kernel_cuda flash_") == "flash attention"
    prof = synthetic_profile()
    assert m.read({"profile": prof, "profiled_units": 2}) == \
        pytest.approx(1e3 * 10e-6 / 2)
