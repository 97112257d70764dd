"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card and raises when there is none; the CPU
    only when asked for explicitly (``device="cpu"``, as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
