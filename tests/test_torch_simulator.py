"""The port's virtual-time simulator (`repro_torch.core.simulator`)
against the JAX package's (`repro.core.simulator`) on the CPU.

The simulator is deterministic by construction (no wall clock, no
randomness), so on the same spec graphs, the port's `RuntimeSimulator`
must give a `SimResult` EQUAL to the reference's in every field and
per-iteration delta: the three paper app graphs of `sim_app_specs`, in
every dependence organization, with and without record-and-replay, over
2 iterations; multi-tenant `run_scopes`; and with tracing and the
metrics plane on."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.taskgraph_apps as japps  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.taskgraph_apps as tapps  # noqa: E402

MODES = ("sync", "dast", "ddast", "sharded")
APPS = ("matmul", "nbody", "sparselu")
CORES = 4


def _fields(res):
    """Every SimResult field, trace events as plain tuples."""
    out = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
    out["events"] = [tuple(e) for e in out["events"]]
    return out


def _both(run):
    """`run(core, apps)` in both packages; their SimResult fields."""
    want = run(jcore, japps)
    got = run(tcore, tapps)
    assert type(got).__module__ == "repro_torch.core.simulator"
    return _fields(got), _fields(want)


@pytest.mark.parametrize("replay", [False, True], ids=["live", "replay"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app", APPS)
def test_run_equals_reference(app, mode, replay):
    got, want = _both(lambda core, apps: core.RuntimeSimulator(
        CORES, mode, replay=replay).run(apps.sim_app_specs(app),
                                        iterations=2))
    assert got == want
    assert got["iterations"] == 2 and len(got["iter_makespans_us"]) == 2
    assert got["tasks"] > 0 and got["makespan_us"] > 0


@pytest.mark.parametrize("replay", [False, True], ids=["live", "replay"])
@pytest.mark.parametrize("mode", MODES)
def test_run_scopes_equals_reference(mode, replay):
    """The three apps as three tenants with weights 1, 2, 1 and a cap of
    8 in-flight tasks on the matmul tenant, 2 iterations each."""
    def run(core, apps):
        return core.RuntimeSimulator(CORES, mode, replay=replay).run_scopes(
            [apps.sim_app_specs("matmul", 4), apps.sim_app_specs("nbody", 3),
             apps.sim_app_specs("sparselu", 6)],
            weights=[1.0, 2.0, 1.0], max_inflight=[8, None, None],
            iterations=2, names=list(APPS))
    got, want = _both(run)
    assert got == want
    assert sorted(got["scopes"]) == sorted(APPS)


@pytest.mark.parametrize("mode", MODES)
def test_traced_metered_run_equals_reference(mode):
    """trace=True and metrics=True: the virtual-µs event timeline and the
    metrics snapshot equal the reference's too."""
    got, want = _both(lambda core, apps: core.RuntimeSimulator(
        CORES, mode, trace=True, metrics=True, replay=True).run(
            apps.sim_app_specs("sparselu", 6), iterations=2))
    assert got == want
    assert got["events"] and got["metrics"]


@pytest.mark.parametrize("kw", [dict(num_shards=3, batch_size=4),
                                dict(placement="shard_affine"),
                                dict(placement="critical_path",
                                     replay=True)],
                         ids=["batched", "shard_affine", "critical_path"])
def test_sharded_options_equal_reference(kw):
    got, want = _both(lambda core, apps: core.RuntimeSimulator(
        CORES, "sharded", **kw).run(apps.sim_app_specs("nbody", 4),
                                    iterations=2))
    assert got == want


def test_costs_default_to_reference():
    assert dataclasses.asdict(tcore.SimCosts()) == \
        dataclasses.asdict(jcore.SimCosts())


def test_dast_needs_two_cores():
    with pytest.raises(ValueError):
        tcore.RuntimeSimulator(1, "dast")
