"""The one place that resolves a `device` argument.

Every entry point of the package takes `device=None` and runs on the card:
`None` means `torch.device("cuda")`.  Where no card is present that is an
error, never a silent fall back to the CPU; a caller that wants the CPU
(the tests do) passes `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; `None` is the CUDA card or an error."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gps_sdr_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
