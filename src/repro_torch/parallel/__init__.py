from repro_torch.parallel.axes import (  # noqa: F401
    ShardingRules,
    current_mesh,
    current_rules,
    logical_spec,
    named_sharding,
    shard,
    use_mesh,
)
