"""The PCG output mix shared by the counter RNG, and the point sets of
``method="qmc"`` (port of ``tpu_montecarlo/ops/qmc.py``): the 1-D rotated
radical inverse and the Sobol dimensions.

The CUDA kernels carry the same mix as ``tmc::pcg`` in
``csrc/counter_rng.cuh`` and the same Sobol words in ``csrc/sobol.cuh``.

Torch has no full uint32 arithmetic and its ``>>`` on int32 is
arithmetic, so words travel as int64 tensors holding values in
``[0, 2**32)``: sums and products of such words with 32-bit constants fit
in int64, and masking them back to 32 bits is exactly uint32 wraparound.

The 1-D point of global index ``g`` takes the top 24 bits of
``bitrev32(g) + derive_shift(seed, 1)``.  Sobol dimension ``j`` is the XOR of the direction numbers selected by the
set bits of the global point index, rotated by a seed-derived uint32
(``derive_shift(seed, j + 1)``) and cut to a 24-bit mantissa, as in the
JAX package.  The direction-number tables are a copy of the JAX
package's (numpy only, so the port imports nothing of it).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MASK32",
    "QMC_MAX_SAMPLES",
    "SOBOL_MAX_DIMS",
    "bitrev32",
    "derive_segment_shift",
    "derive_shift",
    "pcg_mix",
    "qmc_u01_halfopen",
    "qmc_u01_open",
    "sobol_base_bits",
    "sobol_bits",
    "sobol_direction_numbers",
    "sobol_offset_bits",
    "sobol_u01_split",
]

MASK32 = 0xFFFFFFFF
# One segment is one full 2^32-point cycle of the index counter; longer
# runs split into segments, each under its own rotation.
QMC_MAX_SAMPLES = 1 << 32
SOBOL_MAX_DIMS = 32

_INV_2POW24 = float(np.float32(1.0 / (1 << 24)))


def pcg_mix(x: torch.Tensor) -> torch.Tensor:
    """PCG output mix of ``x mod 2**32`` (an int64 tensor of non-negative
    values below 2**62), returned as uint32 words in int64."""
    x = ((x & MASK32) * 747796405 + 2891336453) & MASK32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK32
    return (word >> 22) ^ word


def _word(v) -> torch.Tensor:
    """A uint32 word from a Python int (negative ints wrap, as int32 ->
    uint32 casts do) or from an int64 tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK32
    return torch.tensor(int(v) & MASK32, dtype=torch.int64)


def bitrev32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of each uint32 word (five masked swap steps)."""
    x = _word(x)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) | (x >> 16)) & MASK32


def derive_shift(seed, tag: int) -> torch.Tensor:
    """Seed-derived uint32 rotation of QMC dimension ``tag``."""
    s = _word(seed)
    return pcg_mix(s ^ 0x9E3779B9 ^ ((tag * 0x85EBCA6B) & MASK32))


def qmc_u01_halfopen(idx, shift) -> torch.Tensor:
    """[0, 1) float32 uniforms of the 1-D rotated radical inverse:
    the top 24 bits of ``bitrev32(idx) + shift`` (uint32 wraparound)."""
    m = ((bitrev32(idx) + _word(shift)) & MASK32) >> 8
    return m.to(torch.float32) * _INV_2POW24


def qmc_u01_open(idx, shift) -> torch.Tensor:
    """(0, 1] variant of :func:`qmc_u01_halfopen`, for the exponential's
    logarithm."""
    m = ((bitrev32(idx) + _word(shift)) & MASK32) >> 8
    return (m + 1).to(torch.float32) * _INV_2POW24


def derive_segment_shift(base_shift, seg) -> torch.Tensor:
    """Rotation of segment ``seg`` of a run past one 2^32-point cycle:
    segment 0 keeps ``base_shift``, later ones re-mix it with the segment
    index."""
    base = _word(base_shift)
    seg = _word(seg)
    mixed = pcg_mix(base ^ ((seg * 0x9E3779B9) & MASK32))
    return torch.where(seg == 0, base, mixed)


# (degree s, polynomial a, m_1..m_s) for dimensions 1..15 (0-based; 0 is
# the radical inverse), the Joe-Kuo initial values.
_JOE_KUO = (
    (1, 0, (1,)),
    (2, 1, (1, 3)),
    (3, 1, (1, 3, 1)),
    (3, 2, (1, 1, 1)),
    (4, 1, (1, 1, 3, 3)),
    (4, 4, (1, 3, 5, 13)),
    (5, 2, (1, 1, 5, 5, 17)),
    (5, 4, (1, 1, 5, 5, 5)),
    (5, 7, (1, 1, 7, 11, 19)),
    (5, 11, (1, 1, 5, 1, 1)),
    (5, 13, (1, 1, 1, 3, 11)),
    (5, 14, (1, 3, 5, 5, 31)),
    (6, 1, (1, 1, 3, 3, 9, 7)),
    (6, 13, (1, 1, 5, 13, 3, 15)),
    (6, 16, (1, 3, 3, 9, 25, 25)),
)

# Dimensions 16..31: the JAX package's searched initial values for the
# remaining primitive polynomials of degrees 6 and 7.
_JOE_KUO_EXT = (
    (6, 19, (1, 3, 7, 13, 17, 3)),
    (6, 22, (1, 3, 1, 13, 17, 63)),
    (6, 25, (1, 1, 5, 11, 7, 5)),
    (7, 1, (1, 3, 5, 3, 31, 55, 67)),
    (7, 4, (1, 3, 1, 3, 13, 9, 55)),
    (7, 7, (1, 3, 3, 11, 3, 39, 109)),
    (7, 8, (1, 1, 3, 15, 23, 57, 9)),
    (7, 14, (1, 1, 1, 1, 29, 3, 37)),
    (7, 19, (1, 1, 1, 5, 7, 31, 115)),
    (7, 21, (1, 1, 3, 1, 13, 53, 45)),
    (7, 28, (1, 3, 1, 15, 21, 45, 65)),
    (7, 31, (1, 1, 7, 15, 21, 27, 91)),
    (7, 32, (1, 1, 1, 13, 11, 5, 101)),
    (7, 37, (1, 3, 3, 5, 19, 7, 15)),
    (7, 41, (1, 1, 7, 13, 17, 17, 109)),
    (7, 42, (1, 1, 1, 1, 9, 41, 91)),
)

_ALL_DIMS = _JOE_KUO + _JOE_KUO_EXT


def sobol_direction_numbers(dim: int) -> np.ndarray:
    """(32,) uint32 direction numbers of Sobol dimension ``dim``
    (0-based): v_k = m_k << (31 - k), with m_k from the GF(2) recurrence
    m_k = (XOR_i 2^i a_i m_{k-i}) ^ 2^s m_{k-s} ^ m_{k-s}."""
    if not 0 <= dim < SOBOL_MAX_DIMS:
        raise ValueError(
            f"QMC supports up to {SOBOL_MAX_DIMS} dimensions, got dim {dim}"
        )
    if dim == 0:
        return (np.uint32(1) << np.arange(31, -1, -1, dtype=np.uint32)).astype(
            np.uint32
        )
    s, a, m_init = _ALL_DIMS[dim - 1]
    m = list(m_init)
    for k in range(s, 32):
        value = m[k - s] ^ (m[k - s] << s)
        for i in range(1, s):
            if (a >> (s - 1 - i)) & 1:
                value ^= m[k - i] << i
        m.append(value)
    return np.array(
        [(m[k] << (31 - k)) & MASK32 for k in range(32)], dtype=np.uint32
    )


def _xor_bits(idx: torch.Tensor, v32, first: int, count: int) -> torch.Tensor:
    """XOR of ``v32[first + i]`` over the set bits i < count of ``idx``."""
    x = torch.zeros_like(idx)
    for i in range(count):
        bit = (idx >> i) & 1
        x = x ^ (int(v32[first + i]) * bit)
    return x


def sobol_bits(idx, v32) -> torch.Tensor:
    """uint32 Sobol word of each uint32 index (int64 tensor)."""
    return _xor_bits(_word(idx), v32, 0, 32)


def sobol_offset_bits(pos, v32, pos_bits: int) -> torch.Tensor:
    """Sobol XOR of within-block offsets ``pos < 2**pos_bits``."""
    return _xor_bits(_word(pos), v32, 0, pos_bits)


def sobol_base_bits(b, v32, pos_bits: int, max_bits: int = 32) -> torch.Tensor:
    """Sobol XOR of block index ``b`` placed at index bits
    ``[pos_bits, max_bits)``.  With ``offset`` from
    :func:`sobol_offset_bits`, ``base ^ offset`` equals
    ``sobol_bits((b << pos_bits) | pos)`` (GF(2) linearity)."""
    return _xor_bits(_word(b), v32, pos_bits, max(0, max_bits - pos_bits))


def sobol_u01_split(base_bits, offset_bits, shift, open01: bool = False):
    """Rotated Sobol float32 uniforms from split (base, offset) words:
    [0, 1), or (0, 1] with ``open01``, from the top 24 bits."""
    m = (((base_bits ^ offset_bits) + shift) & MASK32) >> 8
    if open01:
        m = m + 1
    return m.to(torch.float32) * _INV_2POW24
