"""Multi-device building blocks of the port, on `torch.distributed`
(counterpart of `repro.parallel`, its serving part): the partition
specs (`sharding`), the collectives (`comm`), the token-dataflow
attention cores (`ring_attention`, `split_kv_attention`) and the
tensor-parallel placement and seams of the serving forward
(`tensor_parallel`). The sharded train step's modules (`compress`,
`context`) are not ported yet."""
from repro_torch.parallel.ring_attention import (layer_dataflow_attention,
                                                 ring_attention)
from repro_torch.parallel.sharding import (
    ShardingRules,
    batch_axes,
    batch_specs,
    cache_specs,
    paged_pool_spec,
    param_specs,
)
from repro_torch.parallel.split_kv import split_kv_attention

__all__ = [
    "ShardingRules", "param_specs", "batch_specs", "cache_specs",
    "batch_axes", "paged_pool_spec", "ring_attention",
    "layer_dataflow_attention", "split_kv_attention",
]
