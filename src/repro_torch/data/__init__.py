"""Deterministic synthetic data of the port."""
from repro_torch.data.pipeline import (LMDataPipeline, ZipfMarkov,
                                       procedural_images)

__all__ = ["LMDataPipeline", "ZipfMarkov", "procedural_images"]
