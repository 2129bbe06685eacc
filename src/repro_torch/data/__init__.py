from repro_torch.data.pipeline import (
    DataConfig,
    batch_iterator,
    make_batch,
    synthetic_task_batch,
)

__all__ = ["DataConfig", "make_batch", "batch_iterator",
           "synthetic_task_batch"]
