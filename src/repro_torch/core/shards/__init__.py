"""Copy of `repro/core/shards/__init__.py`.

Sharded dependence-manager subsystem.

Partitions dependence management by region hash so the runtime's hot
path has no global serialization point left:

  * :class:`ShardedDependenceGraph` — N independent shard partitions,
    each with its own lock and region map; cross-shard tasks joined by a
    per-WD pending-predecessor :class:`AtomicCounter`;
  * :class:`ShardRouter` — routes Submit/Done messages to per-shard
    mailboxes so each shard has at most one manager mutating it
    (the paper's Submit-exclusivity invariant, per shard);
  * :class:`StealDeque` — per-worker ready deques with owner-side LIFO
    pop and thief-side FIFO steal, replacing the global ready lock.

Used by ``TaskRuntime(mode="sharded")`` and mirrored in virtual time by
``RuntimeSimulator(mode="sharded")``.
"""
from .router import ShardMailbox, ShardRouter
from .sharded_graph import GraphShard, ShardedDependenceGraph
from .steal_deque import AtomicCounter, StealDeque, stable_region_hash

__all__ = [
    "AtomicCounter", "GraphShard", "ShardMailbox", "ShardRouter",
    "ShardedDependenceGraph", "StealDeque", "stable_region_hash",
]
