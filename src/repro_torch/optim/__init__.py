from repro_torch.optim.adamw import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]
