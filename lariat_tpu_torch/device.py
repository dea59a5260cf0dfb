"""The one place that picks the port's device.

The default is ``cuda``; without CUDA that raises. The CPU (where every
kernel wrapper runs its plain PyTorch twin) is used only when a caller asks
for it, through an argument or ``LARIAT_TORCH_DEVICE=cpu``. On a host with
several cards, ``LARIAT_TORCH_DEVICE=cuda:h`` puts a process's engine (the
CLI's or a resident server's) on card h.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Union

import torch

ENV_VAR = "LARIAT_TORCH_DEVICE"


def get_device(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """Resolve ``device`` (or ``$LARIAT_TORCH_DEVICE``, else ``cuda``).

    Raises when CUDA is asked for and absent; never falls back to the CPU
    on its own."""
    if device is None:
        device = os.environ.get(ENV_VAR) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA device {str(dev)!r} requested but torch.cuda is not "
                f"available; pass device='cpu' or set {ENV_VAR}=cpu to run "
                f"the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"CUDA device {str(dev)!r} requested but this host has "
                f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def describe(dev: torch.device) -> str:
    """Human-readable device name for log lines."""
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def contexts() -> list:
    """The indices of the cards on which this process holds an active CUDA
    primary context (the driver's ``cuDevicePrimaryCtxGetState``), in the
    order ``torch.cuda`` numbers them; [] without a CUDA driver. A process
    bound to card h should list [h] and nothing else."""
    try:
        drv = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return []
    ip, up = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint)
    for fn, args in (("cuInit", [ctypes.c_uint]),
                     ("cuDeviceGetCount", [ip]),
                     ("cuDeviceGet", [ip, ctypes.c_int]),
                     ("cuDevicePrimaryCtxGetState", [ctypes.c_int, up, ip])):
        getattr(drv, fn).argtypes = args
        getattr(drv, fn).restype = ctypes.c_int
    n, dev = ctypes.c_int(0), ctypes.c_int(0)
    flags, active = ctypes.c_uint(0), ctypes.c_int(0)
    if drv.cuInit(0) != 0 or drv.cuDeviceGetCount(ctypes.byref(n)) != 0:
        return []
    out = []
    for i in range(n.value):
        if (drv.cuDeviceGet(ctypes.byref(dev), i) == 0
                and drv.cuDevicePrimaryCtxGetState(
                    dev, ctypes.byref(flags), ctypes.byref(active)) == 0
                and active.value):
            out.append(i)
    return out
