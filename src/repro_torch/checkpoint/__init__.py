"""Checkpoints of the port, in the JAX package's on-disk layout."""
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten

__all__ = ["Checkpointer", "flatten"]
