"""repro_torch.models — model configuration and the dense transformer."""
