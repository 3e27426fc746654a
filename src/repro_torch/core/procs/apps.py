"""Copy of `repro/core/procs/apps.py`, with device arrays added.

Process-safe oracle applications for the ``backend="processes"``
driver.

The taskgraph apps used by the threaded tests close over numpy/JAX
arrays living in the submitting process — useless once bodies execute in
a worker process. These kernels instead keep all task data in named
``multiprocessing.shared_memory`` blocks (float64, attached on first
touch and cached per process) and are module-level functions of plain
picklable arguments, so they ship over the exec rings and over the
replay plane alike.

Every kernel is **order-sensitive by construction**: updates are
multiply-accumulate chains (``x = x * c + delta``-shaped), not plain
sums, so executing two tasks that the dependence discipline orders would
produce *different floats* if the runtime ever ran them the other way
round. The test oracle is therefore exact equality against a serial
run of the same kernels in submission order — the strongest ordering
check floats admit.

Three classic graphs, mirroring the threaded suite:

  * blocked matmul  — ``C[i,j] += A[i,k] @ B[k,j]``: an inout chain
    over k per C block, independent across (i, j);
  * sparse LU       — lu0/fwd/bdiv/bmod over a deterministic sparse
    block pattern: the paper's irregular-dependence workhorse;
  * N-Body (flat)   — force rows (in: all positions) then integrate
    rows (inout per row): wide fork-join.

The port adds :class:`DeviceArray`: a tensor the runtime's process owns
(on the card, or in shared memory on the CPU), named by a picklable
:class:`DeviceName`. On the card a worker attaches it through a CUDA IPC
handle (``torch.multiprocessing``'s reduction of the tensor), once per
process; in the owning process ``_attach`` returns the owner's own
tensor from a local registry (a process cannot open its own IPC handle,
and ``run_serial`` and the threaded backend run there). Every kernel
takes either kind of name with the same signature and dependence shape;
on a device array its body is tensor ops over the same index ranges
(``gemm_block`` is one ``addmm_`` with ``beta=0.999``, so k-order still
matters bit for bit; the pivot clamp is a ``torch.where``), and the
driver synchronises the device before it reports the task done.

PyTorch counts the receivers of a CUDA IPC handle: each reduction of a
tensor is one send, which the receiver's storage gives back when it is
freed, and the owner frees a block only once every send is given back
(until then it holds the block and warns at exit that shared tensors
were still held). A device array's handle is reduced once and opened by
every worker, which never frees it (a worker ends in ``os._exit``, or
is killed); so the owner gives the one send back itself in
:meth:`DeviceArray.close_unlink`, after the runtimes that used the array
have shut down.
"""
from __future__ import annotations

import inspect
import secrets
from multiprocessing import shared_memory
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

# per-process attachment cache: workers touch the same blocks for every
# task (and every replay iteration); re-attaching per task would cost a
# syscall per body
_ATTACHED: Dict[str, shared_memory.SharedMemory] = {}


class DeviceName(NamedTuple):
    """The picklable name of a :class:`DeviceArray`: ``key`` is unique,
    ``ipc`` the shared-memory segment's name of a CPU array or the
    pickled CUDA IPC handle of a card's."""
    key: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    ipc: Union[str, bytes]


# the arguments of torch's `rebuild_cuda_tensor` that carry an IPC send's
# reference counter, which the owner gives back
_SEND_COUNTER = ("ref_counter_handle", "ref_counter_offset")


def send_counter(rebuild, args: tuple) -> tuple:
    """The reference counter of a CUDA IPC send `(rebuild, args)` (what
    `reductions.reduce_tensor` gives): the arguments of `rebuild` named
    `ref_counter_handle` and `ref_counter_offset`, found by name in its
    signature. Raises if it has no argument of either name, as it would
    in a PyTorch that renamed or moved them."""
    names = list(inspect.signature(rebuild).parameters)
    missing = [n for n in _SEND_COUNTER if n not in names]
    if missing:
        raise RuntimeError(f"{getattr(rebuild, '__name__', rebuild)} has no "
                           f"argument {' or '.join(missing)}: cannot give "
                           f"a CUDA IPC send back")
    return tuple(args[names.index(n)] for n in _SEND_COUNTER)


# the tensors this process owns, and the ones it attached, by key
_OWNED: Dict[str, torch.Tensor] = {}
_DEVICE_ATTACHED: Dict[str, torch.Tensor] = {}


def _attach(name):
    if isinstance(name, DeviceName):
        return _attach_device(name)
    # attachers are always multiprocessing children of the creator, so
    # the shared resource_tracker makes the attach-side re-register a
    # no-op (see procs.rings.attach_shm); the creator alone unlinks
    shm = _ATTACHED.get(name)
    if shm is None:
        shm = _ATTACHED[name] = shared_memory.SharedMemory(name=name)
    return shm.buf.cast("d")


def _attach_device(name: DeviceName) -> torch.Tensor:
    t = _OWNED.get(name.key)
    if t is None:
        t = _DEVICE_ATTACHED.get(name.key)
    if t is None:
        if isinstance(name.ipc, str):    # a CPU array: its segment
            shm = _ATTACHED.get(name.ipc)
            if shm is None:
                shm = _ATTACHED[name.ipc] = shared_memory.SharedMemory(
                    name=name.ipc)
            t = _tensor_over(shm, name.shape, name.dtype)
        else:                            # opens the CUDA IPC handle
            import pickle
            rebuild, args = pickle.loads(name.ipc)
            t = rebuild(*args)
        _DEVICE_ATTACHED[name.key] = t
    return t


def _tensor_over(shm, shape, dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return torch.frombuffer(shm.buf, dtype=dtype, count=n).view(shape)


class ShmArray:
    """Owner-side named float64 array. Create in the parent, pass
    ``.name`` (a string — picklable) into task args; kernels attach
    lazily wherever they run."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.shm = shared_memory.SharedMemory(create=True, size=8 * n)
        self.name = self.shm.name
        self.view = self.shm.buf.cast("d")
        for i in range(n):
            self.view[i] = 0.0

    def __getitem__(self, i: int) -> float:
        return self.view[i]

    def __setitem__(self, i: int, v: float) -> None:
        self.view[i] = v

    def tolist(self) -> List[float]:
        return [self.view[i] for i in range(self.n)]

    def close_unlink(self) -> None:
        self.view.release()
        self.shm.close()
        try:
            self.shm.unlink()
        except FileNotFoundError:        # pragma: no cover - teardown
            pass


class DeviceArray:
    """Owner-side named tensor, zero-filled: on ``device="cuda"`` a
    tensor on the card shared by CUDA IPC, on ``"cpu"`` one over a
    shared-memory segment. Pass ``.name`` into task args. Keep the array
    until every runtime that ran on it has shut down, then call
    :meth:`close_unlink`."""

    def __init__(self, n: Union[int, Tuple[int, ...]],
                 dtype: torch.dtype = torch.float32,
                 device: str = "cuda") -> None:
        shape = (n,) if isinstance(n, int) else tuple(n)
        self.shape = shape
        self.n = 1
        for d in shape:
            self.n *= d
        key = "dev_" + secrets.token_hex(8)
        dev = torch.device(device)
        self.shm: Optional[shared_memory.SharedMemory] = None
        self._send: Optional[tuple] = None   # the IPC send to give back
        if dev.type == "cpu":
            size = max(1, self.n * torch.empty((), dtype=dtype).itemsize)
            self.shm = shared_memory.SharedMemory(create=True, size=size)
            self.tensor = _tensor_over(self.shm, shape, dtype)
            self.tensor.zero_()
            ipc: Union[str, bytes] = self.shm.name
        elif dev.type == "cuda":
            import pickle
            from torch.multiprocessing import reductions
            self.tensor = torch.zeros(shape, dtype=dtype, device=dev)
            torch.cuda.synchronize(dev)
            # one send: (rebuild_cuda_tensor, its arguments)
            rebuild, args = reductions.reduce_tensor(self.tensor)
            self._send = send_counter(rebuild, args)
            ipc = pickle.dumps((rebuild, args))
        else:
            raise ValueError(f"DeviceArray on {device!r}: use 'cuda' or "
                             f"'cpu'")
        _OWNED[key] = self.tensor
        self.name = DeviceName(key, shape, dtype, ipc)

    def tolist(self) -> List[float]:
        return self.tensor.reshape(-1).tolist()

    def close_unlink(self) -> None:
        _OWNED.pop(self.name.key, None)
        _DEVICE_ATTACHED.pop(self.name.key, None)
        if self._send is not None:       # give the IPC send back
            torch.UntypedStorage._release_ipc_counter_cuda(*self._send)
            self._send = None
        # frees the block on the card, or releases the segment's export
        del self.tensor
        if self.shm is not None:
            self.shm.close()
            try:
                self.shm.unlink()
            except FileNotFoundError:    # pragma: no cover - teardown
                pass


def fill_deterministic(arr: ShmArray, seed: int) -> None:
    """Reproducible non-trivial contents without numpy: an LCG stream."""
    x = (seed * 2654435761 + 1) & 0xFFFFFFFF
    for i in range(arr.n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        arr[i] = (x / 0x7FFFFFFF) - 0.5


def spin(us: float) -> None:
    """A CPU-bound body of roughly ``us`` microseconds: pure arithmetic,
    no syscalls, never releases the GIL — the workload class where the
    threaded driver flatlines and the process backend does not."""
    t = 0.6180339887
    # ~45ns/iter on this class of host; close enough for benchmarking
    for _ in range(max(1, int(us * 22))):
        t = t * t - 0.25 if t < 1.0 else t - 1.0


# ---------------------------------------------------------------------------
# blocked matmul: C[i,j] += A[i,k] . B[k,j], bs x bs blocks in an N x N
# block grid; all three matrices live in one shm array each, row-major
# (N*bs) x (N*bs)

def gemm_block(an: str, bn: str, cn: str, N: int, bs: int,
               i: int, j: int, k: int, spin_us: float = 0.0) -> None:
    if isinstance(cn, DeviceName):
        return _gemm_block_t(an, bn, cn, N, bs, i, j, k, spin_us)
    A, B, C = _attach(an), _attach(bn), _attach(cn)
    dim = N * bs
    if spin_us:
        spin(spin_us)
    for r in range(bs):
        ar = (i * bs + r) * dim + k * bs
        cr = (i * bs + r) * dim + j * bs
        for c in range(bs):
            acc = 0.0
            bc = j * bs + c
            for t in range(bs):
                acc += A[ar + t] * B[(k * bs + t) * dim + bc]
            # multiply-accumulate: k-order matters bit-for-bit
            C[cr + c] = C[cr + c] * 0.999 + acc


def _gemm_block_t(an, bn, cn, N, bs, i, j, k, spin_us):
    dim = N * bs
    A, B, C = (_attach(x).view(dim, dim) for x in (an, bn, cn))
    if spin_us:
        spin(spin_us)
    r, c, t = (slice(x * bs, (x + 1) * bs) for x in (i, j, k))
    # multiply-accumulate: k-order matters bit-for-bit
    C[r, c].addmm_(A[r, t], B[t, c], beta=0.999)


def submit_matmul(rt, an: str, bn: str, cn: str, N: int, bs: int,
                  spin_us: float = 0.0) -> List[tuple]:
    """Submit the blocked matmul; returns the (func, args, deps, label)
    tuples it submitted so a serial oracle can re-run them in order."""
    calls = []
    for i in range(N):
        for j in range(N):
            for k in range(N):
                args = (an, bn, cn, N, bs, i, j, k, spin_us)
                deps = [(("A", i, k), "in"), (("B", k, j), "in"),
                        (("C", i, j), "inout")]
                calls.append((gemm_block, args, deps,
                              f"gemm[{i},{j},{k}]"))
                rt.task(gemm_block, *args, deps=deps,
                        label=f"gemm[{i},{j},{k}]")
    return calls


# ---------------------------------------------------------------------------
# sparse LU over an nb x nb block pattern (bs x bs dense blocks stored
# contiguously per block slot: block (i,j) occupies [(i*nb+j)*bs*bs, ...))

def sparse_pattern(nb: int) -> List[Tuple[int, int]]:
    """Deterministic sparse block structure: diagonal always present,
    off-diagonals from a fixed pseudo-random rule (~40% fill)."""
    pat = []
    for i in range(nb):
        for j in range(nb):
            if i == j or ((i * 7 + j * 13 + (i * j) % 5) % 10) < 4:
                pat.append((i, j))
    return pat


def _boff(nb: int, bs: int, i: int, j: int) -> int:
    return (i * nb + j) * bs * bs


def lu0(mn: str, nb: int, bs: int, k: int) -> None:
    if isinstance(mn, DeviceName):
        return _lu0_t(_blocks(mn, nb, bs)[k, k], bs)
    M = _attach(mn)
    o = _boff(nb, bs, k, k)
    for d in range(bs):
        piv = M[o + d * bs + d]
        if -1e-12 < piv < 1e-12:
            piv = 1.0 if piv >= 0 else -1.0
        for r in range(d + 1, bs):
            M[o + r * bs + d] = M[o + r * bs + d] / piv
            f = M[o + r * bs + d]
            for c in range(d + 1, bs):
                M[o + r * bs + c] = M[o + r * bs + c] - f * M[o + d * bs + c]


def fwd(mn: str, nb: int, bs: int, k: int, j: int) -> None:
    if isinstance(mn, DeviceName):
        blk = _blocks(mn, nb, bs)
        return _fwd_t(blk[k, k], blk[k, j], bs)
    M = _attach(mn)
    ok, oj = _boff(nb, bs, k, k), _boff(nb, bs, k, j)
    for d in range(bs):
        for r in range(d + 1, bs):
            f = M[ok + r * bs + d]
            for c in range(bs):
                M[oj + r * bs + c] = M[oj + r * bs + c] - f * M[oj + d * bs + c]


def bdiv(mn: str, nb: int, bs: int, k: int, i: int) -> None:
    if isinstance(mn, DeviceName):
        blk = _blocks(mn, nb, bs)
        return _bdiv_t(blk[k, k], blk[i, k], bs)
    M = _attach(mn)
    ok, oi = _boff(nb, bs, k, k), _boff(nb, bs, i, k)
    for d in range(bs):
        piv = M[ok + d * bs + d]
        if -1e-12 < piv < 1e-12:
            piv = 1.0 if piv >= 0 else -1.0
        for r in range(bs):
            M[oi + r * bs + d] = M[oi + r * bs + d] / piv
            f = M[oi + r * bs + d]
            for c in range(d + 1, bs):
                M[oi + r * bs + c] = M[oi + r * bs + c] - f * M[ok + d * bs + c]


def bmod(mn: str, nb: int, bs: int, k: int, i: int, j: int) -> None:
    if isinstance(mn, DeviceName):
        blk = _blocks(mn, nb, bs)
        blk[i, j].addmm_(blk[i, k], blk[k, j], alpha=-1)
        return None
    M = _attach(mn)
    oi, oj, ot = (_boff(nb, bs, i, k), _boff(nb, bs, k, j),
                  _boff(nb, bs, i, j))
    for r in range(bs):
        for c in range(bs):
            acc = 0.0
            for t in range(bs):
                acc += M[oi + r * bs + t] * M[oj + t * bs + c]
            M[ot + r * bs + c] = M[ot + r * bs + c] - acc


# the same loops on a device array's blocks: step d's row (or column)
# updates as one tensor op over the host loop's index ranges

def _blocks(mn: DeviceName, nb: int, bs: int) -> torch.Tensor:
    return _attach(mn).view(nb, nb, bs, bs)


def _pivot(piv: torch.Tensor) -> torch.Tensor:
    unit = torch.where(piv >= 0, 1.0, -1.0).to(piv.dtype)
    return torch.where(piv.abs() < 1e-12, unit, piv)


def _lu0_t(B: torch.Tensor, bs: int) -> None:
    for d in range(bs):
        B[d + 1:, d].div_(_pivot(B[d, d]))
        B[d + 1:, d + 1:].addr_(B[d + 1:, d], B[d, d + 1:], alpha=-1)


def _fwd_t(Bk: torch.Tensor, Bj: torch.Tensor, bs: int) -> None:
    for d in range(bs):
        Bj[d + 1:].addr_(Bk[d + 1:, d], Bj[d], alpha=-1)


def _bdiv_t(Bk: torch.Tensor, Bi: torch.Tensor, bs: int) -> None:
    for d in range(bs):
        Bi[:, d].div_(_pivot(Bk[d, d]))
        Bi[:, d + 1:].addr_(Bi[:, d], Bk[d, d + 1:], alpha=-1)


def submit_sparselu(rt, mn: str, nb: int, bs: int) -> List[tuple]:
    pat = set(sparse_pattern(nb))
    calls = []

    def sub(func, args, deps, label):
        calls.append((func, args, deps, label))
        rt.task(func, *args, deps=deps, label=label)

    for k in range(nb):
        sub(lu0, (mn, nb, bs, k), [(("M", k, k), "inout")], f"lu0[{k}]")
        for j in range(k + 1, nb):
            if (k, j) in pat:
                sub(fwd, (mn, nb, bs, k, j),
                    [(("M", k, k), "in"), (("M", k, j), "inout")],
                    f"fwd[{k},{j}]")
        for i in range(k + 1, nb):
            if (i, k) in pat:
                sub(bdiv, (mn, nb, bs, k, i),
                    [(("M", k, k), "in"), (("M", i, k), "inout")],
                    f"bdiv[{k},{i}]")
        for i in range(k + 1, nb):
            if (i, k) not in pat:
                continue
            for j in range(k + 1, nb):
                if (k, j) in pat and (i, j) in pat:
                    sub(bmod, (mn, nb, bs, k, i, j),
                        [(("M", i, k), "in"), (("M", k, j), "in"),
                         (("M", i, j), "inout")],
                        f"bmod[{k},{i},{j}]")
    return calls


# ---------------------------------------------------------------------------
# flat N-Body: pos/vel/acc are n-element shm arrays (1-D bodies keep the
# arithmetic cheap; the dependence shape is what's under test)

def nbody_force(pn: str, an_: str, n: int, i: int) -> None:
    P, A = _attach(pn), _attach(an_)
    if isinstance(pn, DeviceName):
        d = P[:n] - P[i]
        d2 = d * d + 1e-3
        w = d / (d2 * d2)
        w[i] = 0.0                       # j != i
        A[i] = w.sum()
        return None
    acc = 0.0
    xi = P[i]
    for j in range(n):
        if j != i:
            d = P[j] - xi
            d2 = d * d + 1e-3
            acc += d / (d2 * d2)
    A[i] = acc


def nbody_update(pn: str, vn: str, an_: str, i: int,
                 dt: float = 1e-3) -> None:
    P, V, A = _attach(pn), _attach(vn), _attach(an_)
    if isinstance(pn, DeviceName):
        v, p = V[i:i + 1], P[i:i + 1]
        v.copy_(v * 0.999 + A[i:i + 1] * dt)
        p.copy_(p + v * dt)
        return None
    V[i] = V[i] * 0.999 + A[i] * dt
    P[i] = P[i] + V[i] * dt


def submit_nbody(rt, pn: str, vn: str, an_: str, n: int,
                 steps: int = 1) -> List[tuple]:
    calls = []

    def sub(func, args, deps, label):
        calls.append((func, args, deps, label))
        rt.task(func, *args, deps=deps, label=label)

    all_pos = [(("P", j), "in") for j in range(n)]
    for s in range(steps):
        for i in range(n):
            sub(nbody_force, (pn, an_, n, i),
                all_pos + [(("A", i), "out")], f"force[{s},{i}]")
        for i in range(n):
            sub(nbody_update, (pn, vn, an_, i),
                [(("A", i), "in"), (("V", i), "inout"),
                 (("P", i), "inout")], f"update[{s},{i}]")
    return calls


def run_serial(calls: List[tuple]) -> None:
    """The oracle: the exact same kernels, submission order, in-process.
    Any dependence-ordering violation by a parallel backend shows up as
    float inequality against this."""
    for func, args, _deps, _label in calls:
        func(*args)
