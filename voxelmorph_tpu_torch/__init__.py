"""VoxelMorph registration in PyTorch, for NVIDIA Hopper GPUs.

The PyTorch counterpart of ``voxelmorph_tpu``, module for module. Volumes are
channels-last ``(B, *S, C)`` and displacement fields ``(B, *S, N)``, as in the
JAX package. Entry points run on the GPU unless the caller passes
``device="cpu"``; the Pallas kernels of the JAX package are hand-written CUDA
kernels here (``csrc/``), built with ``nvcc`` at first use.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a torch.device; raise if it names an absent GPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "voxelmorph_tpu_torch runs on the GPU by default, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return device


from . import generators, layers, losses, ops, py  # noqa: E402
from . import models  # noqa: E402
from . import networks  # noqa: E402,F401
from . import utils  # noqa: E402,F401
from . import parallel, registration, training  # noqa: E402
