"""Shared integrator plumbing: user-function tracing and device
resolution (port of ``tpu_montecarlo/api/base.py:75-96``).

The JAX package's routing gate between its kernel and its XLA sweep is not
ported: the port has one path, the kernel, with no VMEM budget to fit."""

from __future__ import annotations

import torch

from ..tracing import TracedFunction, trace_function
from ..utils.roadmap import FRONT_END, not_ported


def resolve_device(device) -> torch.device:
    """``device`` as a torch device.  A CUDA device that is not there
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch version"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {device!r}")
    return dev


class _BaseMixin:
    def _trace_user_functions(self, functions, n_args: int = 1) -> tuple:
        if len(functions) == 0:
            raise ValueError("At least one function is required")
        traced = []
        for func in functions:
            if isinstance(func, str):
                raise not_ported("WGSL source strings", FRONT_END)
            if callable(func) or isinstance(func, TracedFunction):
                traced.append(trace_function(func, n_args))
            else:
                raise TypeError(
                    f"Function must be callable or WGSL string, got {type(func)}"
                )
        return tuple(traced)
