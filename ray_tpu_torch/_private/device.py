"""Device resolution for the port's entry points.

Entry points run on the card by default. With no CUDA device they raise
instead of carrying on quietly on the CPU; a caller that wants the CPU
(the tests) asks for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def checked_device(device: DeviceLike = None) -> torch.device:
    """``device`` as given (``None``: "cuda"), without choosing a card.
    Raises when a CUDA device is asked for (explicitly or by default)
    and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA card (the first one unless the
    process chose another). Raises when a CUDA device is asked for
    (explicitly or by default) and none is available."""
    dev = checked_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
