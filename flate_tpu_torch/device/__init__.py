"""PyTorch device side of the encoder and the decoder; each module mirrors
its namesake in the JAX package's `jx/`."""

from __future__ import annotations

import torch

from ..errors import DeviceUnavailable


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bit patterns (the
    layout the CUDA kernels read and write)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch.device an entry point runs on.  CUDA asked for and absent
    raises; there is no quiet fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable("CUDA device requested but "
                                    "torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
