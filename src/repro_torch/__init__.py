"""PyTorch/CUDA port of the ElastiFormer serving path (see README.md).

Imports no JAX and nothing of the JAX package ``repro``; builds no kernel at
import time (the first kernel launch builds them, ``kernels/build.py``).
"""
