"""Copy of `repro/core/taskgraph_apps.py`, each task body a PyTorch call
on the caller's device.

The paper's evaluation applications (§4.2) on the task runtime.

Each app exists in two forms:
  * ``sim_*_specs``  — a SimTaskSpec graph with virtual durations, consumed
    by core.simulator (reproduces Figs 5-11 scalability/tuning results);
  * ``run_*``        — a real execution on core.runtime.TaskRuntime where
    each task body is a PyTorch block operation on ``device`` (numpy in,
    numpy out; validates runtime correctness against dense oracles).

Dependence patterns follow the paper exactly:
  Matmul    — regular, independent chains per output block (§4.2.1)
  N-Body    — regular chains + NESTED tasks (§4.2.2): one top-level task
              per timestep creates the per-block children
  Sparse LU — complex irregular pattern (§4.2.3)

Each app additionally has a ``run_*_epochs`` variant that re-submits the
SAME task graph once per epoch with a root taskwait between epochs (the
paper's iterative usage: matmul epochs, N-Body timesteps, repeated
sparse-LU factorizations) — the shape the record-and-replay subsystem
(``engine/replay.py``, ``replay=True`` on both drivers) turns into
analysis-free steady-state iterations.

**One stream carries the dependences.** A body returns once its kernels
are enqueued, not once they have run, so the runtime marks a task done,
and releases its successors, while its kernels may still be queued on
the card. Every runner therefore reads the calling thread's current CUDA
stream on entry and runs every body inside it (``torch.cuda.stream``),
on whichever worker thread executes the body. A successor is submitted
only after its predecessors' bodies have returned, so its kernels sit
behind theirs in that stream: stream order carries every dependence.
Without it a worker thread would enqueue on its own current stream (the
default one) and race a caller that runs on a side stream. Every tensor
a runner allocates is made on that stream too, so the caching allocator
reuses its blocks only behind work already queued there. The price:
independent tasks never overlap on the device. On the CPU there is no
stream and a body's ops finish before it returns.

The block bodies are library calls and plain tensor ops, as the JAX
package computes them outside any Pallas kernel (none is a hand-written
kernel):
  ``_gemm_block``  — ``c.addmm_(a, b)``: C(i,j) += A(i,k) @ B(k,j) in
                     place, one GEMM with beta = 1 into a view of C;
  ``_lu0``         — the unpivoted in-block LU as a column loop over
                     tensor slices, the masked ``fori_loop``'s arithmetic
                     (an entry the mask leaves is left as it is); the same
                     function on every device;
  ``_fwd``/``_bdiv`` — ``torch.linalg.solve_triangular`` (unit lower for
                     ``_fwd``; ``left=False`` against the upper part for
                     ``_bdiv``);
  ``_bmod``        — ``inner - row @ col``;
  ``_forces_block``/``_update_block`` — the softened gravity sums and the
                     Euler step, elementwise ops and a reduction.

The ``*_oracle`` functions are the reference's numpy oracles; the
``*_oracle_torch`` functions compute the same sequential algorithms in a
chosen dtype on a chosen device, so a large run on the card is checked
in float64 there.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .simulator import SimTaskSpec
from .wd import DepMode

IN, OUT, INOUT = DepMode.IN, DepMode.OUT, DepMode.INOUT


def sim_app_specs(app: str, scale: Optional[int] = None) -> List[SimTaskSpec]:
    """Named access to the three paper app graphs at a given scale —
    the sweep axis used by benchmarks/bench_shards.py and the CI smoke
    run. ``scale`` is nb for matmul/sparselu and nblocks for nbody."""
    if app == "matmul":
        return sim_matmul_specs(scale or 8, dur_us=100.0)
    if app == "nbody":
        return sim_nbody_specs(scale or 8, timesteps=2)
    if app == "sparselu":
        return sim_sparselu_specs(scale or 10)
    raise ValueError(f"unknown app {app!r} (matmul|nbody|sparselu)")


def _on_stream(device: DeviceLike) -> Tuple[torch.device, Callable]:
    """The resolved device and a context factory that enters, on any
    thread, the CUDA stream current on the calling thread now (a no-op
    context on the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, contextlib.nullcontext
    return dev, functools.partial(torch.cuda.stream,
                                  torch.cuda.current_stream(dev))


def _as(x, dev: torch.device,
        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`x` (an array or a tensor) on `dev`, in `dtype` or its own. Where
    neither changes, the tensor shares `x`'s memory: callers only read
    it."""
    return torch.as_tensor(x).to(dev, dtype)


def _views(t: torch.Tensor, nb: int, bs: int
           ) -> Dict[Tuple[int, int], torch.Tensor]:
    return {(i, j): t[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
            for i in range(nb) for j in range(nb)}


# ===========================================================================
# Matmul (§4.2.1): C[i,j] += A[i,k] @ B[k,j]
# ===========================================================================

def sim_matmul_specs(nb: int, dur_us: float = 100.0) -> List[SimTaskSpec]:
    """nb x nb blocked matmul task graph; nb**3 tasks; per-output-block
    chains of length nb (the paper's 'several independent chains')."""
    specs = []
    for i in range(nb):
        for j in range(nb):
            for k in range(nb):
                specs.append(SimTaskSpec(
                    dur=dur_us,
                    deps=[(("A", i, k), IN), (("B", k, j), IN),
                          (("C", i, j), INOUT)],
                    label=f"gemm{i}.{j}.{k}"))
    return specs


def _gemm_block(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    """C block += A block @ B block, in place (one GEMM, beta = 1)."""
    c.addmm_(a, b)


def _matmul_graph(rt, a: np.ndarray, b: np.ndarray, bs: int, epochs: int,
                  device: DeviceLike) -> np.ndarray:
    """The nb³ gemm graph submitted `epochs` times into C, zeroed once,
    with a root taskwait after each submission. The blocks are views of
    one device tensor a matrix; the C blocks accumulate in place."""
    ms = a.shape[0]
    assert ms % bs == 0
    nb = ms // bs
    dev, on = _on_stream(device)
    at, bt = _as(a, dev), _as(b, dev)
    ct = torch.zeros_like(at)
    ab, bb, cb = _views(at, nb, bs), _views(bt, nb, bs), _views(ct, nb, bs)

    def gemm(i: int, j: int, k: int) -> None:
        with on():
            _gemm_block(ab[(i, k)], bb[(k, j)], cb[(i, j)])

    for _ in range(epochs):
        for i in range(nb):
            for j in range(nb):
                for k in range(nb):
                    rt.task(gemm, i, j, k,
                            deps=[(("A", i, k), IN), (("B", k, j), IN),
                                  (("C", i, j), INOUT)],
                            label=f"gemm{i}.{j}.{k}")
        rt.taskwait()
    return ct.cpu().numpy()


def run_matmul(rt, a: np.ndarray, b: np.ndarray, bs: int,
               device: DeviceLike = "cuda") -> np.ndarray:
    """Blocked matmul on the task runtime. Returns C = A @ B."""
    return _matmul_graph(rt, a, b, bs, 1, device)


def run_matmul_epochs(rt, a: np.ndarray, b: np.ndarray, bs: int,
                      epochs: int, device: DeviceLike = "cuda") -> np.ndarray:
    """Iterative blocked matmul: the same nb³ gemm graph submitted
    ``epochs`` times into the accumulating C blocks (one root taskwait
    per epoch). Returns C = epochs * (A @ B) — structurally identical
    iterations, the record-and-replay steady-state case."""
    return _matmul_graph(rt, a, b, bs, epochs, device)


def matmul_oracle_torch(a, b, device: DeviceLike = "cuda",
                        dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """A @ B in `dtype` on `device`, one call."""
    dev = resolve_device(device)
    return _as(a, dev, dtype) @ _as(b, dev, dtype)


# ===========================================================================
# Sparse LU (§4.2.3): blocked LU over a sparse block pattern
# ===========================================================================

def sparse_pattern(nb: int) -> List[List[bool]]:
    """BSC SparseLU-style initial block occupancy: diagonal + an irregular
    subset (creates the paper's 'much more complex and irregular' graph)."""
    return [[i == j or (i + j) % 3 != 1 or j == 0 or i == 0
             for j in range(nb)] for i in range(nb)]


def sim_sparselu_specs(nb: int, dur_lu0: float = 120.0,
                       dur_fwd: float = 100.0, dur_bdiv: float = 100.0,
                       dur_bmod: float = 110.0) -> List[SimTaskSpec]:
    present = sparse_pattern(nb)
    specs = []
    for k in range(nb):
        specs.append(SimTaskSpec(dur=dur_lu0, deps=[(("M", k, k), INOUT)],
                                 label=f"lu0.{k}"))
        for j in range(k + 1, nb):
            if present[k][j]:
                specs.append(SimTaskSpec(
                    dur=dur_fwd,
                    deps=[(("M", k, k), IN), (("M", k, j), INOUT)],
                    label=f"fwd.{k}.{j}"))
        for i in range(k + 1, nb):
            if present[i][k]:
                specs.append(SimTaskSpec(
                    dur=dur_bdiv,
                    deps=[(("M", k, k), IN), (("M", i, k), INOUT)],
                    label=f"bdiv.{i}.{k}"))
        for i in range(k + 1, nb):
            if not present[i][k]:
                continue
            for j in range(k + 1, nb):
                if not present[k][j]:
                    continue
                present[i][j] = True  # fill-in
                specs.append(SimTaskSpec(
                    dur=dur_bmod,
                    deps=[(("M", i, k), IN), (("M", k, j), IN),
                          (("M", i, j), INOUT)],
                    label=f"bmod.{i}.{j}.{k}"))
    return specs


def _lu0(d: torch.Tensor) -> torch.Tensor:
    """Unpivoted in-block LU (reference kernel of the BSC benchmark): for
    each pivot k, the column below it divided by the pivot, then the
    trailing block less the outer product of that column and the pivot's
    row. A new tensor; `d` is left as it is."""
    m = d.clone()
    for k in range(m.shape[0] - 1):
        m[k + 1:, k] /= m[k, k]
        m[k + 1:, k + 1:] -= torch.outer(m[k + 1:, k], m[k, k + 1:])
    return m


def _fwd(diag: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Solve L x = c where L is the (unit-diag) lower part of `diag`."""
    return torch.linalg.solve_triangular(diag, c, upper=False,
                                         unitriangular=True)


def _bdiv(diag: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve x U = r where U is the upper part of `diag`."""
    return torch.linalg.solve_triangular(diag, r, upper=True, left=False)


def _bmod(row: torch.Tensor, col: torch.Tensor,
          inner: torch.Tensor) -> torch.Tensor:
    return inner - row @ col


def _load_linalg(dev: torch.device) -> None:
    """PyTorch loads its CUDA linear-algebra kernels on the first call of
    one, and that first call fails ("lazy wrapper should be called at most
    once") when two threads make it at once, as two workers' first
    triangular solves do: one small solve on the calling thread first."""
    if dev.type == "cuda":
        one = torch.ones((1, 1), device=dev)
        torch.linalg.solve_triangular(one, one, upper=True)


def run_sparselu(rt, m: np.ndarray, bs: int,
                 device: DeviceLike = "cuda") -> np.ndarray:
    """Blocked sparse LU on the runtime; returns packed LU factors."""
    ms = m.shape[0]
    nb = ms // bs
    dev, on = _on_stream(device)
    _load_linalg(dev)
    present = sparse_pattern(nb)
    mt = _as(m, dev)
    blocks: Dict[Tuple[int, int], Optional[torch.Tensor]] = {
        ij: (blk.clone() if present[ij[0]][ij[1]] else None)
        for ij, blk in _views(mt, nb, bs).items()}

    def lu0(k):
        with on():
            blocks[(k, k)] = _lu0(blocks[(k, k)])

    def fwd(k, j):
        with on():
            blocks[(k, j)] = _fwd(blocks[(k, k)], blocks[(k, j)])

    def bdiv(i, k):
        with on():
            blocks[(i, k)] = _bdiv(blocks[(k, k)], blocks[(i, k)])

    def bmod(i, j, k):
        with on():
            inner = blocks[(i, j)]
            if inner is None:
                inner = torch.zeros((bs, bs), dtype=torch.float32,
                                    device=dev)
            blocks[(i, j)] = _bmod(blocks[(i, k)], blocks[(k, j)], inner)

    for k in range(nb):
        rt.task(lu0, k, deps=[(("M", k, k), INOUT)], label=f"lu0.{k}")
        for j in range(k + 1, nb):
            if present[k][j]:
                rt.task(fwd, k, j,
                        deps=[(("M", k, k), IN), (("M", k, j), INOUT)],
                        label=f"fwd.{k}.{j}")
        for i in range(k + 1, nb):
            if present[i][k]:
                rt.task(bdiv, i, k,
                        deps=[(("M", k, k), IN), (("M", i, k), INOUT)],
                        label=f"bdiv.{i}.{k}")
        for i in range(k + 1, nb):
            if not present[i][k]:
                continue
            for j in range(k + 1, nb):
                if not present[k][j]:
                    continue
                present[i][j] = True
                rt.task(bmod, i, j, k,
                        deps=[(("M", i, k), IN), (("M", k, j), IN),
                              (("M", i, j), INOUT)],
                        label=f"bmod.{i}.{j}.{k}")
    rt.taskwait()
    out = torch.zeros_like(mt)
    outb = _views(out, nb, bs)
    for ij, blk in blocks.items():
        if blk is not None:
            outb[ij].copy_(blk)
    return out.cpu().numpy()


def run_sparselu_epochs(rt, mats: List[np.ndarray], bs: int,
                        device: DeviceLike = "cuda") -> List[np.ndarray]:
    """Repeated sparse-LU factorizations: one epoch per input matrix,
    each submitting the identical task graph (the sparsity pattern —
    and with it the fill-in and the dependence structure — is fixed by
    ``sparse_pattern``, not by the values)."""
    return [run_sparselu(rt, m, bs, device) for m in mats]


def sparselu_oracle(m: np.ndarray, bs: int) -> np.ndarray:
    """Sequential reference of the same blocked algorithm (numpy)."""
    ms = m.shape[0]
    nb = ms // bs
    present = sparse_pattern(nb)
    blocks = {}
    for i in range(nb):
        for j in range(nb):
            blocks[(i, j)] = (m[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
                              .astype(np.float64).copy()
                              if present[i][j] else None)

    def lu0(d):
        d = d.copy()
        n = d.shape[0]
        for k in range(n):
            d[k + 1:, k] /= d[k, k]
            d[k + 1:, k + 1:] -= np.outer(d[k + 1:, k], d[k, k + 1:])
        return d

    for k in range(nb):
        blocks[(k, k)] = lu0(blocks[(k, k)])
        dk = blocks[(k, k)]
        l = np.tril(dk, -1) + np.eye(bs)
        u = np.triu(dk)
        for j in range(k + 1, nb):
            if present[k][j]:
                blocks[(k, j)] = np.linalg.solve(l, blocks[(k, j)])
        for i in range(k + 1, nb):
            if present[i][k]:
                blocks[(i, k)] = np.linalg.solve(u.T, blocks[(i, k)].T).T
        for i in range(k + 1, nb):
            if not present[i][k]:
                continue
            for j in range(k + 1, nb):
                if not present[k][j]:
                    continue
                present[i][j] = True
                inner = blocks[(i, j)]
                if inner is None:
                    inner = np.zeros((bs, bs))
                blocks[(i, j)] = inner - blocks[(i, k)] @ blocks[(k, j)]
    out = np.zeros_like(m)
    for (i, j), blk in blocks.items():
        if blk is not None:
            out[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = blk
    return out


def sparselu_oracle_torch(m, bs: int, device: DeviceLike = "cuda",
                          dtype: torch.dtype = torch.float64
                          ) -> torch.Tensor:
    """`sparselu_oracle` in `dtype` on `device`, sequentially on the
    calling thread: the packed LU factors as a tensor there."""
    dev = resolve_device(device)
    mt = _as(m, dev, dtype)
    nb = mt.shape[0] // bs
    present = sparse_pattern(nb)
    blocks = {ij: (blk.clone() if present[ij[0]][ij[1]] else None)
              for ij, blk in _views(mt, nb, bs).items()}
    for k in range(nb):
        blocks[(k, k)] = dk = _lu0(blocks[(k, k)])
        for j in range(k + 1, nb):
            if present[k][j]:
                blocks[(k, j)] = _fwd(dk, blocks[(k, j)])
        for i in range(k + 1, nb):
            if present[i][k]:
                blocks[(i, k)] = _bdiv(dk, blocks[(i, k)])
        for i in range(k + 1, nb):
            if not present[i][k]:
                continue
            for j in range(k + 1, nb):
                if not present[k][j]:
                    continue
                present[i][j] = True
                inner = blocks[(i, j)]
                if inner is None:
                    inner = torch.zeros((bs, bs), dtype=dtype, device=dev)
                blocks[(i, j)] = _bmod(blocks[(i, k)], blocks[(k, j)], inner)
    out = torch.zeros_like(mt)
    outb = _views(out, nb, bs)
    for ij, blk in blocks.items():
        if blk is not None:
            outb[ij].copy_(blk)
    return out


# ===========================================================================
# N-Body (§4.2.2): blocked particles, NESTED tasks per timestep
# ===========================================================================

def sim_nbody_specs(nblocks: int, timesteps: int, dur_force: float = 150.0,
                    dur_update: float = 30.0, dur_parent: float = 5.0,
                    nested: bool = True) -> List[SimTaskSpec]:
    """Per timestep: pairwise force(i,j) tasks chained on F(i) (the
    paper's 'regular chained pattern similar to the Matmul one', §4.2.2 —
    nblocks² force tasks per step matches the paper's task counts), then
    update(i). With `nested`, each timestep is one top-level task whose
    body creates the children (the paper notes this nesting makes the
    Submit requests latency-critical because they block parallelism)."""
    specs: List[SimTaskSpec] = []
    for ts in range(timesteps):
        children = []
        for i in range(nblocks):
            for j in range(nblocks):
                children.append(SimTaskSpec(
                    dur=dur_force,
                    deps=[(("P", i), IN), (("P", j), IN), (("F", i), INOUT)],
                    label=f"force.{ts}.{i}.{j}"))
        for i in range(nblocks):
            children.append(SimTaskSpec(
                dur=dur_update,
                deps=[(("F", i), IN), (("P", i), INOUT)],
                label=f"update.{ts}.{i}"))
        if nested:
            specs.append(SimTaskSpec(dur=dur_parent, deps=[(("TS",), INOUT)],
                                     children=children,
                                     label=f"step.{ts}"))
        else:
            specs.extend(children)
    return specs


def _forces_block(pi: torch.Tensor, pall: torch.Tensor,
                  mall: torch.Tensor) -> torch.Tensor:
    """Gravity forces on block-i particles from all particles (softened)."""
    d = pall[None, :, :] - pi[:, None, :]
    r2 = torch.sum(d * d, dim=-1) + 1e-6
    inv_r3 = torch.where(r2 > 1e-5, r2 ** -1.5, 0.0)
    return torch.sum(d * (mall[None, :] * inv_r3)[..., None], dim=1)


def _update_block(p: torch.Tensor, v: torch.Tensor, f: torch.Tensor,
                  dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    v = v + f * dt
    return p + v * dt, v


def _nbody_graph(rt, pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                 bs: int, timesteps: int, dt: float, wait_each: bool,
                 device: DeviceLike):
    """One nested step task a timestep: its body submits the force and
    update children and taskwaits on them. `wait_each` adds a root
    taskwait after each step's submission (the epochs variant)."""
    n = pos.shape[0]
    nb = n // bs
    dev, on = _on_stream(device)
    p = list(_as(pos, dev).split(bs))
    v = list(_as(vel, dev).split(bs))
    mall = _as(mass, dev)
    f: List[Optional[torch.Tensor]] = [None] * nb

    def force(i):
        with on():
            pall = torch.cat(p, dim=0)
            f[i] = _forces_block(p[i], pall, mall)

    def update(i):
        with on():
            p[i], v[i] = _update_block(p[i], v[i], f[i], dt)

    def step(ts):
        for i in range(nb):
            rt.task(force, i,
                    deps=[(("P", j), IN) for j in range(nb)]
                    + [(("F", i), OUT)],
                    label=f"force.{ts}.{i}")
        for i in range(nb):
            rt.task(update, i, deps=[(("F", i), IN), (("P", i), INOUT)],
                    label=f"update.{ts}.{i}")
        rt.taskwait()

    for ts in range(timesteps):
        rt.task(step, ts, deps=[(("TS",), INOUT)], label=f"step.{ts}")
        if wait_each:
            rt.taskwait()
    if not wait_each:
        rt.taskwait()
    return (torch.cat(p).cpu().numpy(), torch.cat(v).cpu().numpy())


def run_nbody(rt, pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
              bs: int, timesteps: int, dt: float = 0.01,
              device: DeviceLike = "cuda"):
    """Blocked n-body with nested tasks: one parent task per timestep."""
    return _nbody_graph(rt, pos, vel, mass, bs, timesteps, dt, False, device)


def run_nbody_epochs(rt, pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                     bs: int, timesteps: int, dt: float = 0.01,
                     device: DeviceLike = "cuda"):
    """Iterative n-body: ONE nested step task per epoch with a root
    taskwait after each (``run_nbody`` submits all steps up front; this
    variant is the steady-state timestep loop the paper describes and
    record-and-replay elides — every epoch is the same one-parent
    nested structure)."""
    return _nbody_graph(rt, pos, vel, mass, bs, timesteps, dt, True, device)


def nbody_oracle(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                 timesteps: int, dt: float = 0.01):
    p = pos.astype(np.float32).copy()
    v = vel.astype(np.float32).copy()
    for _ in range(timesteps):
        d = p[None, :, :] - p[:, None, :]
        r2 = np.sum(d * d, axis=-1) + 1e-6
        inv_r3 = np.where(r2 > 1e-5, r2 ** -1.5, 0.0)
        f = np.sum(d * (mass[None, :] * inv_r3)[..., None], axis=1)
        v = v + f * dt
        p = p + v * dt
    return p, v


# Rows of the [rows, N, 3] difference tensor `nbody_oracle_torch` forms at
# a time: 400 MB in float64 at N = 16,384.
_ORACLE_ROWS = 1024


def nbody_oracle_torch(pos, vel, mass, timesteps: int, dt: float = 0.01,
                       device: DeviceLike = "cuda",
                       dtype: torch.dtype = torch.float64):
    """`nbody_oracle` in `dtype` on `device`, unblocked in time (every
    particle's force from the positions before the step), its pairwise
    sums taken `_ORACLE_ROWS` rows at a time. Returns (p, v) tensors."""
    dev = resolve_device(device)
    p, v, m = (_as(x, dev, dtype) for x in (pos, vel, mass))
    for _ in range(timesteps):
        f = torch.cat([_forces_block(pi, p, m)
                       for pi in p.split(_ORACLE_ROWS)])
        v = v + f * dt
        p = p + v * dt
    return p, v
