"""Device and dtype resolution shared by the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  A
request for CUDA on a machine without it raises: nothing silently carries
on on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (np.float32 -> torch.float32)."""
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype
