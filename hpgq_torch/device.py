"""Device choice for the port.

The device is always explicit: ``"cuda"`` (the CLI's and the API's
default) or ``"cpu"`` when asked for.  Asking for CUDA where there is none
raises :class:`DeviceUnavailable`; nothing falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` ("cuda", "cuda:N", "cpu" or a
    ``torch.device``); raises :class:`DeviceUnavailable` for a CUDA device
    this machine does not have."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "device %r was requested but CUDA is not available here "
                "(use device='cpu' to run on the CPU)" % str(device))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise DeviceUnavailable("no CUDA device %d (this machine has %d)"
                                    % (dev.index, torch.cuda.device_count()))
    elif dev.type != "cpu":
        raise DeviceUnavailable("unsupported device %r (use cuda or cpu)"
                                % str(device))
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
