"""SPMD layer of the port: sharding rules and activation constraints;
counterpart of `repro/parallel/`."""
from .collectives import constrain, mesh_scope, moe_mode, strategy
from .sharding import (MeshShape, ShardingRules, Spec, batch_specs,
                       cache_sharding, make_rules, param_sharding,
                       shard_cache_tree, shard_tree)

__all__ = ["MeshShape", "ShardingRules", "Spec", "batch_specs",
           "cache_sharding", "constrain", "make_rules", "mesh_scope",
           "moe_mode", "param_sharding", "shard_cache_tree", "shard_tree",
           "strategy"]
