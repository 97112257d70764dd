"""Serving engine of the port."""
from repro_torch.training.serve import GenRequest, ServingEngine

__all__ = ["GenRequest", "ServingEngine"]
