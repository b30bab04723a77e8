# device.py — explicit device choice and float32 numerics.
"""The port runs where the caller says: ``resolve_device("cuda")`` or
``resolve_device("cpu")``.  Nothing picks a device at import time, and
asking for CUDA without a card raises instead of falling back.

Resolving a device also pins float32 matrix products to full precision
(no TF32 on the card): the grid composition and pHash matmuls must stay
true float32 to give the JAX package's bytes.
"""
from __future__ import annotations

import torch


def configure_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(name: str) -> torch.device:
    """'cuda' (card 0, or 'cuda:N') or 'cpu' -> torch.device."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but "
                               "torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    configure_numerics()
    return dev
