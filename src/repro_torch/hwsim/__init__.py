"""repro_torch.hwsim — the ARTEMIS hardware simulator (copies of
`repro.hwsim` constants, dram, workloads, dataflow and baselines) that
prices every serve step on the engine's virtual clock and carries the
published baseline anchors of Figs 9-11."""
from repro_torch.hwsim.constants import (
    ArtemisConfig,
    DEFAULT,
    DRISA_CONFIG,
)
from repro_torch.hwsim.dram import DramGeometry
from repro_torch.hwsim.dataflow import (
    DataflowConfig,
    simulate_model,
    simulate_breakdown,
)
from repro_torch.hwsim.workloads import paper_models
from repro_torch.hwsim.baselines import BASELINES

__all__ = ["ArtemisConfig", "DEFAULT", "DRISA_CONFIG", "DramGeometry",
           "DataflowConfig", "simulate_model", "simulate_breakdown",
           "paper_models", "BASELINES"]
