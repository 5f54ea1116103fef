"""
gordo_tpu_torch: the PyTorch/CUDA port of gordo-tpu.

The package trains fleets of feedforward autoencoders
(``parallel/fleet_build.py``: cross-validation thresholds, final fit,
artifacts) and serves their anomaly scores on an NVIDIA Hopper card. Its
whole fleet forward, in serving and in cross-validation scoring, is one
hand-written CUDA kernel (``ops/csrc/fleet_dense.cu``). It imports
torch, numpy and the standard library only.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises instead of
moving to the CPU.
"""

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when the caller names it.

    >>> resolve_device("cpu")
    device(type='cpu')
    """
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {resolved}; use 'cuda' or 'cpu'")
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return resolved
