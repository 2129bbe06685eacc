"""repro_torch.core — the ARTEMIS mixed analog-stochastic arithmetic in
PyTorch (counterpart of `repro.core`).

Public surface:
  ArithmeticPolicy, EXACT/INT8/ARTEMIS/ARTEMIS_MXU presets
  artemis_matmul          the MAC pipeline (all modes)
  sc_multiply             deterministic TCU multiply, closed form
  grouped_signed_accumulate / MomcapConfig   analog accumulation model
  lse_softmax / artemis_softmax              Eq. 5 softmax (exact / LUT)
  lut_activation                             NSC LUT nonlinearities
"""
from repro_torch.core.analog import (
    MomcapConfig,
    grouped_signed_accumulate,
    max_linear_accumulations,
    momcap_voltage_trace,
    readout_quantize,
)
from repro_torch.core.artemis_matmul import artemis_matmul, calibrate_rbar
from repro_torch.core.lut import binned_apply, lut_activation
from repro_torch.core.policy import (
    ARTEMIS,
    ARTEMIS_MXU,
    EXACT,
    INT8,
    ArithmeticPolicy,
)
from repro_torch.core.quantization import (
    SC_LEVELS,
    dequantize,
    fake_quant,
    magnitude_sign,
    quant_scale,
    quantize,
)
from repro_torch.core.softmax import (
    artemis_softmax,
    lse_softmax,
    online_max_sum,
)
from repro_torch.core.stochastic import (
    SC_BITS,
    sc_multiply,
    sc_multiply_bitstream,
    sc_multiply_float,
    sc_truncation_error,
    spread_encode,
    tcu_encode,
)

__all__ = [
    "ArithmeticPolicy", "EXACT", "INT8", "ARTEMIS", "ARTEMIS_MXU",
    "artemis_matmul", "calibrate_rbar",
    "MomcapConfig", "grouped_signed_accumulate", "readout_quantize",
    "momcap_voltage_trace", "max_linear_accumulations",
    "lse_softmax", "artemis_softmax", "online_max_sum",
    "binned_apply", "lut_activation",
    "SC_LEVELS", "SC_BITS", "quantize", "dequantize", "quant_scale",
    "fake_quant", "magnitude_sign",
    "sc_multiply", "sc_multiply_bitstream", "sc_multiply_float",
    "sc_truncation_error", "tcu_encode", "spread_encode",
]
