"""Device selection for the port.

Every function of the port takes an explicit ``device``. The card is the
default place to run; the CPU is used only when a caller passes a CPU
device explicitly (the CPU tests do, and get each kernel's plain
PyTorch version).
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """``torch.device("cuda")``, or raise when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this path runs on an NVIDIA GPU; pass "
            "device=torch.device('cpu') explicitly for the plain CPU path")
    return torch.device("cuda")
