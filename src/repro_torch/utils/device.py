"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is absent instead of quietly
    running on the CPU. On a CUDA device, TF32 is switched off for matmuls and
    cuDNN, because the JAX reference computes in full f32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def input_device(device, *inputs) -> torch.device:
    """Where an entry point runs: ``device`` when given, else the device of
    the first tensor among ``inputs`` (the caller placed it), else the card
    as ``resolve_device(None)`` picks it — never the CPU by default."""
    if device is None:
        device = next((t.device for t in inputs if isinstance(t, torch.Tensor)), None)
    return resolve_device(device)
