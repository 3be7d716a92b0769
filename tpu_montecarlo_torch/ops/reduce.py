"""A sum in a fixed order, the same bits whatever the batch around it.

A torch reduction picks its order from the shape it is given (on CUDA
the threads per output depend on the number of outputs), so a sum over
the blocks of one job could change its last bits when the job runs
inside a batch.  :func:`fixed_sum` adds in a pairwise tree of
elementwise adds instead: every element of its result is the same
sequence of float additions for any batch size and on any device.  The
MCMC finish and the error-bar pilots use it; the integrate kernels sum
their blocks in a second pass of their own (``csrc/rows_sum.cuh``)."""

from __future__ import annotations

import torch

__all__ = ["fixed_sum"]


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` summed over ``dim`` in a pairwise tree: zero-padded to a
    power of two, then halved by elementwise adds of the two halves
    (ceil(log2 n) adds).  Each slice's bits depend on that slice alone."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim=dim)
    width = 1 << (n - 1).bit_length()
    if width != n:
        pad = list(x.shape)
        pad[dim] = width - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while width > 1:
        width //= 2
        x = x.narrow(dim, 0, width) + x.narrow(dim, width, width)
    return x.squeeze(dim)
