"""Checkpoints of the port: ``repro``'s npz format, read and written
bit-exactly, and the TrainState bridge from ``repro``."""
from repro_torch.checkpoint.io import (from_numpy_tree, restore, save,
                                       train_state_from_numpy)

__all__ = ["from_numpy_tree", "restore", "save", "train_state_from_numpy"]
