# device.py — explicit device choice, float32 numerics, host data on a card.
"""The port runs where the caller says: ``resolve_device("cuda")`` or
``resolve_device("cpu")``.  Nothing picks a device at import time, and
asking for CUDA without a card raises instead of falling back.

Resolving a device also pins float32 matrix products to full precision
(no TF32 on the card): the grid composition and pHash matmuls must stay
true float32 to give the JAX package's bytes.

Host data reaches a device in two ways.  ``constant`` builds a table once
per device and hands the same tensor back afterwards, so a batch step
copies nothing from the host and can be captured into a CUDA graph
(utils/graphs.py).  ``upload`` moves a batch's inputs through pinned
memory without waiting for the device: torch copies pageable host memory
to a card behind a stream synchronisation.  The pinning is a ``host.pin``
span (utils/profiling.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import profiling

_constants: dict = {}


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


def constant(key, device, make) -> torch.Tensor:
    """The tensor of the host data ``make()`` returns (a numpy array or
    anything ``torch.as_tensor`` takes), on `device`, built at the first
    call for (`key`, `device`) and the same tensor afterwards.  Callers
    only read it."""
    k = (key, torch.device(device))
    t = _constants.get(k)
    if t is None:
        t = _constants[k] = torch.as_tensor(make(), device=k[1])
    return t


def upload(data, dtype, device) -> torch.Tensor:
    """Host data (a list or an array) as a `dtype` tensor on `device`
    (None: the CPU).  On a card the copy goes from pinned memory and does
    not wait for the device."""
    host = torch.as_tensor(np.asarray(data), dtype=dtype)
    device = torch.device(device or "cpu")
    if device.type != "cuda":
        return host.to(device)
    with profiling.span("host.pin", bytes=host.nbytes):
        host = host.pin_memory()
    return host.to(device, non_blocking=True)
