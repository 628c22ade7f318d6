"""The device an entry point runs on: the card, unless the caller names one."""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means the card ("cuda"; under a
    launcher that sets `LOCAL_RANK`, such as torchrun, the card of that
    index), and a RuntimeError where there is none: an entry point never
    moves to the CPU on its own. Pass `device="cpu"` to run there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the port runs on an "
            "NVIDIA GPU unless the caller passes device='cpu'")
    if "LOCAL_RANK" not in os.environ:
        return torch.device("cuda")
    local = int(os.environ["LOCAL_RANK"])
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local}, but this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", local)
