"""Device resolution for the port's entry points.

``resolve_device(None)`` means the CUDA card.  Without one it raises: the
port never carries on silently on the CPU.  The CPU runs only when the
caller asks for it (``device="cpu"``), as the tests do, and then every
kernel wrapper takes its plain PyTorch version.

On CUDA it also turns TF32 off for matmuls and cuDNN: the reference is
full float32, and TF32 keeps only about three decimal digits.  And it
makes cuDNN deterministic (its default weight-gradient algorithm for the
cifar convnet's convolutions sums with atomics, so two runs of one fleet
differed by an ulp): a resumed, a telemetry-on or a kernels-off run is
then bitwise the run it is held against.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU")
        # full f32, like the reference (both default to off for matmul in
        # current PyTorch, but cuDNN's TF32 defaults to on)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

