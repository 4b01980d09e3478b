from repro_torch.distributed.sharding import (
    ShardingEnv, activate, active_env, axis_size, logical_constraint,
    logical_sharding, resolve_spec,
)

__all__ = [
    "ShardingEnv", "activate", "active_env", "axis_size", "logical_constraint",
    "logical_sharding", "resolve_spec",
]
