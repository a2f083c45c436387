"""Hand-written CUDA kernels of the port, their plain PyTorch versions,
and the model-layout wrappers (:mod:`repro_torch.kernels.ops`)."""
