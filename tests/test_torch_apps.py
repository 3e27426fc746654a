"""The port's three applications (`repro_torch.core.taskgraph_apps`:
blocked Matmul, nested N-Body, Sparse LU) against the JAX package's
(`repro.core.taskgraph_apps`) on the CPU.

Each of the six runners runs in each of the four dependence
organizations on the port's `TaskRuntime` with `device="cpu"`, beside
the reference runner on the reference `TaskRuntime` on the same numpy
inputs, with the same mode and workers. The port's result must be within
`rel` times the reference result's largest magnitude of it (1e-5 for
Matmul and N-Body, 1e-4 for Sparse LU; elementwise relative error means
nothing where a velocity component cancels to ~0), within
`tests/test_runtime.py`'s tolerances of the numpy oracle, and the two
runtimes must execute the same number of tasks. The epochs variants run
under `replay=True`. Replay-hit, message and steal counts race in the
JAX package's own tests and are never asserted."""
from typing import Callable, NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.taskgraph_apps as japps  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.taskgraph_apps as tapps  # noqa: E402

MODES = ("sync", "dast", "ddast", "sharded")


def _mat(seed, n, diag=0.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, n).astype(np.float32)
            + diag * np.eye(n, dtype=np.float32))


def _bodies(seed, n):
    rng = np.random.RandomState(seed)
    pos = rng.rand(n, 3).astype(np.float32)
    mass = rng.rand(n).astype(np.float32)
    return pos, np.zeros((n, 3), np.float32), mass


A, B = _mat(42, 64), _mat(43, 64)          # 4 x 4 blocks of 16
AE = _mat(7, 48)                            # 3 x 3 blocks, 3 epochs
M = _mat(0, 96, diag=96.0)                  # 4 x 4 blocks of 24
MS = [_mat(11 + i, 48, diag=48.0) for i in range(2)]
NB = _bodies(7, 64)                         # 4 blocks of 16, 3 steps
NBE = _bodies(5, 32)                        # 4 blocks of 8, 4 steps


class Case(NamedTuple):
    call: Callable          # (apps module, runtime, **device) -> arrays
    oracle: Callable        # () -> arrays the numpy oracle gives
    tasks: int
    rel: float              # vs the reference runner
    rtol: float             # vs the oracle (tests/test_runtime.py's)
    atol: float
    workers: int = 3
    replay: bool = False


def _nbody_oracle(bodies, steps):
    return list(japps.nbody_oracle(*bodies, steps))


def _lu_tasks(n, bs):
    return len(japps.sim_sparselu_specs(n // bs))


CASES = {
    "run_matmul": Case(
        lambda m, rt, **d: [m.run_matmul(rt, A, B, 16, **d)],
        lambda: [A @ B], 4 ** 3, 1e-5, 1e-4, 1e-4),
    "run_matmul_epochs": Case(
        lambda m, rt, **d: [m.run_matmul_epochs(rt, AE, AE, 16, 3, **d)],
        lambda: [3 * (AE @ AE)], 3 * 3 ** 3, 1e-5, 1e-3, 1e-3,
        replay=True),
    "run_sparselu": Case(
        lambda m, rt, **d: [m.run_sparselu(rt, M, 24, **d)],
        lambda: [japps.sparselu_oracle(M, 24)], _lu_tasks(96, 24), 1e-4,
        2e-3, 2e-3),
    "run_sparselu_epochs": Case(
        lambda m, rt, **d: m.run_sparselu_epochs(rt, MS, 16, **d),
        lambda: [japps.sparselu_oracle(x, 16) for x in MS],
        2 * _lu_tasks(48, 16), 1e-4, 2e-3, 2e-3, replay=True),
    "run_nbody": Case(
        lambda m, rt, **d: list(m.run_nbody(rt, *NB, 16, 3, **d)),
        lambda: _nbody_oracle(NB, 3), 3 * (2 * 4 + 1), 1e-5, 1e-3, 1e-3,
        workers=2),
    "run_nbody_epochs": Case(
        lambda m, rt, **d: list(m.run_nbody_epochs(rt, *NBE, 8, 4, **d)),
        lambda: _nbody_oracle(NBE, 4), 4 * (2 * 4 + 1), 1e-5, 1e-3, 1e-4,
        replay=True),
}


def _run(apps, core, case: Case, mode: str, **device):
    with core.TaskRuntime(num_workers=case.workers, mode=mode,
                          replay=case.replay) as rt:
        out = case.call(apps, rt, **device)
    return out, rt.stats.tasks_executed


def _close(got, want, rel):
    """|got - want| <= rel * max |want|, entry by entry."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_runner_matches_reference_and_oracle(name, mode):
    case = CASES[name]
    want, want_tasks = _run(japps, jcore, case, mode)
    got, got_tasks = _run(tapps, tcore, case, mode, device="cpu")
    assert got_tasks == want_tasks == case.tasks
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), case.rel)
    for g, o in zip(got, case.oracle()):
        np.testing.assert_allclose(g, o, rtol=case.rtol, atol=case.atol)


def test_runners_default_to_the_card():
    """No GPU here: the default device raises rather than fall back to
    the CPU, before any task is submitted."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device would run")
    with tcore.TaskRuntime(num_workers=2) as rt:
        with pytest.raises(RuntimeError, match="cuda"):
            tapps.run_matmul(rt, A, B, 16)
    assert rt.stats.tasks_executed == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_matmul_oracle_torch(dtype):
    got = tapps.matmul_oracle_torch(A, B, "cpu", dtype)
    assert got.dtype == dtype and got.device.type == "cpu"
    want = A.astype(np.float64) @ B.astype(np.float64)
    rel = 1e-6 if dtype == torch.float32 else 1e-12
    _close(got.double().numpy(), want, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sparselu_oracle_torch(dtype):
    got = tapps.sparselu_oracle_torch(M, 24, "cpu", dtype)
    assert got.dtype == dtype
    # the numpy oracle in float64 throughout (its output takes m's dtype)
    want = japps.sparselu_oracle(M.astype(np.float64), 24)
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    _close(got.double().numpy(), want, rel)


def test_nbody_oracle_torch():
    """The numpy oracle runs in float32: the torch oracle in float32
    agrees to 1e-5 of the largest magnitude, in float64 to 1e-3."""
    want = _nbody_oracle(NB, 3)
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-3)):
        got = tapps.nbody_oracle_torch(*NB, 3, device="cpu", dtype=dtype)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            _close(g.double().numpy(), w.astype(np.float64), rel)


def _norm(specs):
    """A spec list as plain values: label, duration, (region, mode name)
    dependences and the children, recursively."""
    if specs is None:
        return None
    return [(s.label, s.dur, [(r, m.name) for r, m in s.deps],
             _norm(s.children)) for s in specs]


SPEC_CALLS = {
    "app matmul": lambda m: m.sim_app_specs("matmul"),
    "app nbody": lambda m: m.sim_app_specs("nbody"),
    "app sparselu": lambda m: m.sim_app_specs("sparselu"),
    "app matmul 3": lambda m: m.sim_app_specs("matmul", 3),
    "app nbody 5": lambda m: m.sim_app_specs("nbody", 5),
    "app sparselu 7": lambda m: m.sim_app_specs("sparselu", 7),
    "matmul dur": lambda m: m.sim_matmul_specs(5, dur_us=37.5),
    "nbody flat": lambda m: m.sim_nbody_specs(4, 3, dur_force=60.0,
                                              dur_update=15.0,
                                              nested=False),
    "sparselu durs": lambda m: m.sim_sparselu_specs(9, 1.0, 2.0, 3.0, 4.0),
}


@pytest.mark.parametrize("name", sorted(SPEC_CALLS))
def test_sim_specs_equal_reference(name):
    got = _norm(SPEC_CALLS[name](tapps))
    assert got and got == _norm(SPEC_CALLS[name](japps))


def test_sim_app_specs_rejects_unknown_app():
    with pytest.raises(ValueError):
        tapps.sim_app_specs("cholesky")


@pytest.mark.parametrize("nb", [1, 4, 9])
def test_sparse_pattern_equal_reference(nb):
    assert tapps.sparse_pattern(nb) == japps.sparse_pattern(nb)
