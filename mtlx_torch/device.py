"""Device resolution for the port's entry points.

`None` means the CUDA device: the port is written for the card, and a
missing card is an error, never a silent move to the CPU. The CPU runs
only when the caller names it (the tests pass `device="cpu"`), and then
every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or the current CUDA device when it is None. Raises when
    a CUDA device is asked for (explicitly or by default) and none is
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: mtlx_torch entry points run on the "
                "CUDA device by default; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev
