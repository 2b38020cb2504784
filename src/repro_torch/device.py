"""Where the port's entry points run.

Every entry point takes a ``device`` argument and runs on CUDA unless the
caller names another device. Without a GPU, an entry point called with no
device raises instead of dropping to the CPU: a run that was meant for the
card never silently measures the CPU.
"""

from __future__ import annotations

import functools
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device; anything else as given.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the kernels'
    wrappers size their split grids by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count
