"""The device rule of every entry point of the port."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def resolve_device(device) -> torch.device:
    """``cuda`` (with its index: the current card when none is given) or
    ``cpu`` as a ``torch.device``; ``cuda`` without a card raises, and
    nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def traced(t: torch.Tensor) -> bool:
    """True for a fake tensor: the dry run's stand-in for a tensor on the
    card (``launch/steps.lower_cell``), which has shapes and dtypes and
    no data, whatever device it names."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """A kernel wrapper's dispatch: True for a CUDA tensor (launch the
    kernel) and for a fake one (``traced``: it takes the card's path,
    and a wrapper counts the kernel's call instead of launching it),
    False for a real CPU one (the plain version); others raise."""
    if t.device.type == "cuda" or traced(t):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels take CPU or CUDA tensors, "
                     f"not {t.device}")
