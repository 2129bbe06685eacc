"""Multi-device building blocks of the port, on `torch.distributed`
(counterpart of `repro.parallel`): the partition specs (`sharding`),
the collectives (`comm`), the sharding context (`context`), the
token-dataflow attention cores (`ring_attention`,
`split_kv_attention`), the tensor-parallel placement and seams
(`tensor_parallel`), the sharded train step's FSDP and data
parallelism (`data_parallel`) and the compressed gradient all-reduce
(`compress`)."""
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
