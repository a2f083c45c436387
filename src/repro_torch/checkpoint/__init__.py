"""Checkpoints of the port: ``repro``'s npz format, read bit-exactly."""
from repro_torch.checkpoint.io import from_numpy_tree, restore

__all__ = ["from_numpy_tree", "restore"]
