"""repro_torch.core — the arithmetic policy (the ARTEMIS arithmetic
itself is not ported yet: only `mode="exact"` runs)."""
from repro_torch.core.policy import (
    ARTEMIS,
    ARTEMIS_MXU,
    EXACT,
    INT8,
    ArithmeticPolicy,
)

__all__ = ["ArithmeticPolicy", "EXACT", "INT8", "ARTEMIS", "ARTEMIS_MXU"]
