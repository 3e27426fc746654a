"""The work a kernel's inputs need, from their shapes, and the least time
the card could take for it: the larger of the operations at the peak
rate and the bytes at the memory rate, each input read once and each
output written once, whatever the kernel reads again. Copied from
`chip_smoke.py` (`bound`, `bwd_bound`, `live_pairs`, `attn_bound`,
`scan_bound`) and `analysis/roofline.py` (`model_flops`), with the
grouped GEMM's rows per expert taken as routed, never as the capacity.

Each function returns seconds and the term that binds ("operations" or
"bytes").
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

from .peaks import EXP2_FMA_FLOPS, Peaks

Bound = Tuple[float, str]


def _bound(flops: float, nbytes: float, fps: float, bps: float) -> Bound:
    t_ops, t_bytes = flops / fps, nbytes / bps
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def add(bounds: Iterable[Bound]) -> Bound:
    """Bounds of launches that run one after another: their sum, named by
    the term that binds most of it."""
    bounds = list(bounds)
    total = sum(t for t, _ in bounds)
    ops = sum(t for t, by in bounds if by == "operations")
    return total, "operations" if ops >= total - ops else "bytes"


# ------------------------------------------------------------ grouped GEMM
def grouped_gemm(rows: Sequence[int], d_in: int, d_out: int, itemsize: int,
                 p: Peaks) -> Bound:
    """One grouped product x [rows_e, d_in] @ w_e [d_in, d_out] over the
    experts: 2 rows d_in d_out flops; x read, the weights of every expert
    that some row reaches read, y written."""
    n = sum(rows)
    used = sum(1 for r in rows if r)
    flops = 2 * n * d_in * d_out
    nbytes = itemsize * (n * d_in + used * d_in * d_out + n * d_out)
    return _bound(flops, nbytes, p.bf16_fps, p.hbm_bps)


def grouped_gemm_dx(rows, d_in, d_out, itemsize, p) -> Bound:
    """dx [rows_e, d_in] = dy [rows_e, d_out] @ w_e^T: dy and the reached
    weights read, dx written."""
    return grouped_gemm(rows, d_out, d_in, itemsize, p)


def grouped_gemm_dw(rows, d_in, d_out, itemsize, p) -> Bound:
    """dw_e [d_in, d_out] = x_e^T @ dy_e: x and dy read, the dw of every
    reached expert written."""
    n = sum(rows)
    used = sum(1 for r in rows if r)
    flops = 2 * n * d_in * d_out
    nbytes = itemsize * (n * d_in + n * d_out + used * d_in * d_out)
    return _bound(flops, nbytes, p.bf16_fps, p.hbm_bps)


def moe_layer(rows, d, f, itemsize, p, backward: bool) -> list:
    """The three grouped products of an expert layer (gate and up d -> f,
    down f -> d), one launch each, and with `backward` their dx and dw."""
    shapes = ((d, f), (d, f), (f, d))
    out = [grouped_gemm(rows, a, b, itemsize, p) for a, b in shapes]
    if backward:
        out += [grouped_gemm_dx(rows, a, b, itemsize, p) for a, b in shapes]
        out += [grouped_gemm_dw(rows, a, b, itemsize, p) for a, b in shapes]
    return out


# -------------------------------------------------------------- attention
def live_pairs(b: int, nq: int, s: int, t: Optional[int] = None,
               causal: bool = True, window: Optional[int] = None) -> int:
    """The (query, key) pairs the masks leave: all S x T without a causal
    mask; with one (S == T) query i sees min(i + 1, window) keys."""
    if not causal:
        return b * nq * s * (t or s)
    w = min(window or s, s)
    return b * nq * (w * (w + 1) // 2 + (s - w) * w)


def attention_fwd(b, s, nq, nkv, hd, itemsize, p, causal=True,
                  window=None) -> Bound:
    """QK^T and PV over the live pairs (2 hd flops a pair each); q, k, v
    read, o and the f32 log-sum-exp written."""
    pairs = live_pairs(b, nq, s, s, causal, window)
    flops = 2 * 2 * hd * pairs
    q = b * s * nq * hd
    kv = 2 * b * s * nkv * hd
    nbytes = itemsize * (2 * q + kv) + 4 * b * nq * s
    return _bound(flops, nbytes, p.bf16_fps, p.hbm_bps)


def attention_bwd(b, s, nq, nkv, hd, itemsize, p, causal=True,
                  window=None) -> Bound:
    """The backward's 5 products over the live pairs (S again, dV, dP,
    dQ, dK); q, k, v, o, do and lse read, dq, dk, dv written."""
    pairs = live_pairs(b, nq, s, s, causal, window)
    flops = 5 * 2 * hd * pairs
    q = b * s * nq * hd
    kv = 2 * b * s * nkv * hd
    nbytes = itemsize * (4 * q + 2 * kv) + 4 * b * nq * s
    return _bound(flops, nbytes, p.bf16_fps, p.hbm_bps)


# ---------------------------------------------------------- selective scan
def selective_scan(b: int, s: int, d: int, n: int, itemsize: int,
                   p: Peaks) -> Bound:
    """Mamba's selective scan forward: x, dt, B, C read and y written in
    the activation dtype, A, D and the f32 final state; B S D N
    exponentials and 6 B S D N f32 flops, a share of the exponentials on
    the FMA pipes so that both pipes finish together."""
    nbytes = itemsize * (3 * b * s * d + 2 * b * s * n) \
        + 4 * (d * n + d + b * d * n)
    exps, flops = b * s * d * n, 6 * b * s * d * n
    share = (exps * p.f32_fps - flops * p.sfu_eps) / (
        exps * p.f32_fps + exps * EXP2_FMA_FLOPS * p.sfu_eps)
    share = min(1.0, max(0.0, share))
    t_ops = max((1 - share) * exps / p.sfu_eps,
                (flops + share * exps * EXP2_FMA_FLOPS) / p.f32_fps)
    t_bytes = nbytes / p.hbm_bps
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------------- whole model
def model_flops(active_params: int, tokens: int, train: bool) -> float:
    """6 N D for a training step, 2 N D for a forward
    (`analysis/roofline.py` `model_flops`)."""
    return (6.0 if train else 2.0) * active_params * tokens
