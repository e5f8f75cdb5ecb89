"""Device selection for the PyTorch port.

Every entry point runs on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a machine without a CUDA device
raises instead of carrying on quietly on the host.  The tests pass
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point builds its tensors on.

    ``None`` selects the first CUDA device.  A CUDA request on a machine
    without one raises ``RuntimeError`` naming ``device="cpu"``, the only
    way to run the port on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the port on the CPU")
        # Reference precision: float32 products run in full float32, never
        # TF32 -- the counterpart of the Precision.HIGHEST that every
        # reference matmul of the JAX package pins.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """``None`` -> float32, the accelerator path's dtype; float64 is
    fully supported."""
    dt = torch.float32 if dtype is None else dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype!r}")
    return dt
