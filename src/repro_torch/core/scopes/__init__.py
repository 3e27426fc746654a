"""Copy of `repro/core/scopes/__init__.py`.

Multi-tenant job scopes: concurrent independent taskgraphs in ONE
shared runtime.

The paper's asynchronous organization — threads *request* dependence
actions and idle threads play distributed manager — was built for one
application graph, but nothing in the request/mailbox discipline
requires a single requester. This subsystem makes the requester
first-class: a :class:`~repro_torch.core.scopes.scope.JobScope` is an
independent root context (own root WD, own ``taskwait()`` quiescence,
own dependence namespace, own record-and-replay slot) and any number of
them submit concurrently into the same workers, shards, and mailboxes.

Three pieces, each plugging into an existing layer:

  * :class:`~repro_torch.core.scopes.scope.JobScope` + the
    :func:`~repro_torch.core.scopes.scope.scoped_deps` keying shim — the ONE
    place scope identity enters the dependence system: every region a
    scope touches is wrapped as ``ScopedRegion(scope, region)`` at the
    policy boundary, so two scopes touching ``("A", 0, 0)`` can never
    create a cross-scope false dependence, hash to independent shards,
    and keep independent placement-affinity entries — in all four
    policies, with zero policy changes.
  * :class:`~repro_torch.core.scopes.policy.ScopedPolicy` — a multiplexer
    over any live :class:`~repro_torch.core.engine.policy.DependencePolicy`
    that gives each scope its own
    :class:`~repro_torch.core.engine.replay.ReplayPolicy` recording slot (and
    LRU cache), routed by the ``WorkDescriptor.scope`` stamp, so each
    client's iterative workload records, freezes, and replays
    independently of every other tenant.
  * :class:`~repro_torch.core.scopes.admission.FairAdmission` — a layer
    between ready-task production and the
    :class:`~repro_torch.core.sched.placement.PlacementPolicy`: per-scope
    bounded GIL-atomic ready rings drained by weighted deficit
    round-robin with per-scope ``max_inflight`` backpressure. No new
    locks on the hot path.

Both drivers speak the same objects: ``TaskRuntime(num_clients=N)``
grows ``open_scope()``; ``RuntimeSimulator.run_scopes([...], ...)``
runs one virtual client core per scope.
"""
from .admission import FairAdmission
from .policy import ScopedPolicy, scope_rollup
from .scope import JobScope, ScopedRegion, scoped_deps

__all__ = ["FairAdmission", "JobScope", "ScopedPolicy", "ScopedRegion",
           "scope_rollup", "scoped_deps"]
