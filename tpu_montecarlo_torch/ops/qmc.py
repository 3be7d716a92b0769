"""The PCG output mix shared by the counter RNG (port of
``tpu_montecarlo/ops/qmc.py:_pcg_mix``).

Only the hash is ported in this slice; the radical inverse and Sobol
streams of ``method="qmc"`` are later work.  The CUDA kernels carry the
same mix as ``tmc::pcg`` in ``csrc/counter_rng.cuh``.

Torch has no full uint32 arithmetic and its ``>>`` on int32 is
arithmetic, so words travel as int64 tensors holding values in
``[0, 2**32)``: sums and products of such words with 32-bit constants fit
in int64, and masking them back to 32 bits is exactly uint32 wraparound.
"""

from __future__ import annotations

import torch

__all__ = ["MASK32", "pcg_mix"]

MASK32 = 0xFFFFFFFF


def pcg_mix(x: torch.Tensor) -> torch.Tensor:
    """PCG output mix of ``x mod 2**32`` (an int64 tensor of non-negative
    values below 2**62), returned as uint32 words in int64."""
    x = ((x & MASK32) * 747796405 + 2891336453) & MASK32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK32
    return (word >> 22) ^ word
