"""XspecT2 read classification on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``xspect2_tpu`` that keeps its on-disk
formats (``.bbsi`` index directories, model metadata JSON, result JSON)
and its results.  This package imports PyTorch and numpy only.

Every entry point takes ``device=None``, which means ``"cuda"``.  A run
without a CUDA card raises unless the caller asks for ``"cpu"``; on the
CPU the kernels' plain PyTorch versions compute the same integers.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA card is present: nothing falls back to the CPU
    silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xspect2_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: expected 'cuda' or 'cpu'")
    return dev
