"""Where the port puts tensors that it builds from host data.

The port's entry points run on the card: numpy arrays, lists and scipy
matrices given to a constructor, and a numpy ``b`` given to an action, go
to the default device, which is ``cuda`` unless a caller changes it with
``set_default_device``. An explicit ``device=`` always wins, and a tensor
keeps its device. Without a usable CUDA device a default of ``cuda``
raises instead of carrying on on the CPU; a CPU caller asks for it with
``device="cpu"`` or ``set_default_device("cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["set_default_device", "default_device", "resolve_device",
           "host_tensor", "action_vector"]

_default = torch.device("cuda")


def set_default_device(device) -> torch.device:
    """Set the device for tensors built from host data; returns the
    previous one."""
    global _default
    prev, _default = _default, torch.device(device)
    return prev


def default_device() -> torch.device:
    return _default


def resolve_device(device=None) -> torch.device:
    """``device`` when given, else the default; raises RuntimeError when
    that is a CUDA device and CUDA is unavailable."""
    dev = torch.device(device) if device is not None else _default
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"exponentialutilities_jl_torch builds host data on {dev}, but "
            "torch.cuda.is_available() is False: pass device=\"cpu\" or "
            "call exponentialutilities_jl_torch.set_default_device(\"cpu\")")
    return dev


def host_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """``a`` as a tensor: a tensor keeps its device unless ``device`` is
    given; host data (numpy, lists, scalars) goes to ``resolve_device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=resolve_device(device))


def action_vector(b, op) -> torch.Tensor:
    """An action's vector (or column block) ``b``: a tensor on its own
    device, host data on the operator's device (the default device for an
    operator without one); a real ``b`` of a complex operator is promoted
    to the operator's type, so that the Krylov basis can hold A b."""
    if not isinstance(b, torch.Tensor):
        b = host_tensor(b, getattr(op, "device", None))
    op_dt = getattr(op, "dtype", None)
    if isinstance(op_dt, torch.dtype) and op_dt.is_complex:
        b = b.to(torch.promote_types(b.dtype, op_dt))
    return b
