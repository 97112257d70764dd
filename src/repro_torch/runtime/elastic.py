"""Elastic scaling helpers: the mesh shapes a job may move to.

An own copy of the pure part of the JAX package's ``runtime/elastic.py``.
Its ``reshard`` and ``rescale_training_state`` /
``rescale_serving_state`` (a live re-mesh of the serving and training
state) arrive with ROADMAP Queue A item 11's second half.
"""
from __future__ import annotations


def valid_mesh_shapes(n_devices: int, model_axis: int):
    """The (data, model) shapes available after losing or gaining hosts:
    the model axis kept, halved or doubled where it divides the device
    count (the controller picks the largest batch-preserving one)."""
    out = []
    for m in (model_axis, model_axis // 2, model_axis * 2):
        if m and n_devices % m == 0:
            out.append((n_devices // m, m))
    return out
