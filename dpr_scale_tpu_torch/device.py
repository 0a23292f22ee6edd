"""Device choice for the port (counterpart of ``dpr_scale_tpu/parallel/mesh.py``).

The port runs on one card (serving and training), so there is no mesh:
each factory either gets an explicit device or takes ``cuda:0``. There is no silent CPU
fallback — the CPU runs the kernels' plain versions, and a caller asks for
it by name.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda:0``, which
    must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda", 0)
