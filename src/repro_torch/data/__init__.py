"""Deterministic synthetic data of the port."""
from repro_torch.data.pipeline import LMDataPipeline, ZipfMarkov

__all__ = ["LMDataPipeline", "ZipfMarkov"]
