"""`repro_torch` — the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The port mirrors ``repro``'s layout (``configs/``, ``models/``,
``kernels/``, ``runtime/``, ``api/``, ``launch/``, ``checkpoint/``,
``obs/``) so each module's counterpart is easy to find. It imports torch
and numpy, never jax, and nothing from ``repro``. Its entry points run on
the CUDA card unless the caller asks for the CPU (``device="cpu"``).

Slice 1 ports split-inference serving of the dense LM family (the
``continuous`` and ``paged`` engines), slice 2 PSL training of it, and
slice 3 the ``speculative`` engine and serving of the Mamba-1 (ssm)
family. Attention, the speculative window's attention, the selective
scan and the LM-head cross-entropy run on hand-written CUDA kernels
(``repro_torch/csrc``). Slice 8 ports the paper's CNN workload and its
baselines, slice 9 Latent Dirichlet Sampling and the vectorized epoch
planner (``core/planner.py``, torch tensor code on the card).
"""
