"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, grown slice by slice.

The JAX package ``repro`` is the reference; this package mirrors its
module paths and names (``repro.train.cnn_step`` ->
``repro_torch.train.cnn_step``) and never imports it or ``jax``.
Every kernel that ``repro`` wrote in Pallas for the TPU is a CUDA kernel
written by hand here (``csrc/``), with a plain PyTorch version beside it
that the CPU tests run.

All float math is fp32: :func:`fp32_math` turns TF32 off for both
matrix products and cuDNN convolutions, and every entry point calls it.
"""
from __future__ import annotations

import torch


def fp32_math() -> None:
    """Full-fp32 products and convolutions (TF32 off on both paths;
    the cuDNN flag defaults to True)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """Entry points default to ``"cuda"``; a CUDA device that is not
    there is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    return dev
