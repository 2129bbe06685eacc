"""repro_torch — the ARTEMIS serving stack in PyTorch, for NVIDIA Hopper.

A port of `repro` (the JAX package, which stays the reference) that
mirrors its layout so each module has a counterpart:

  configs/  models/config.py   model configurations (copies)
  core/                        the arithmetic-policy switchboard (copy)
                               and the ARTEMIS arithmetic (quantization,
                               TCU multiply, MOMCAP readout,
                               artemis_matmul)
  hwsim/                       the ARTEMIS hardware simulator (copies)
  models/                      `nn.Module` transformer + shared layers
  kernels/                     hand-written CUDA kernels for sm_90a,
                               each beside its plain PyTorch version
  serve/                       the continuous-batching engine over a
                               paged KV cache
  data/ optim/ checkpoint/     training: the data pipeline, AdamW, the
                               checkpoint manager
  launch/serve.py, train.py    the serving and training CLIs
  bridge.py                    numpy parameter trees <-> the port's
                               model (and AdamW's state)

Entry points take an explicit `device` (default "cuda") and raise when
no CUDA device is found; pass `device="cpu"` to run on the CPU, where
every kernel wrapper takes its plain version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
