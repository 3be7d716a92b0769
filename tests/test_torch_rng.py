"""The port's counter RNG against the JAX package's ``CounterRng``.

The JAX kernel draws from ``CounterRng`` off the TPU (interpret mode); the
port implements it bit for bit, so words and uniforms must be bit-equal
for every (seed, program, counter, tag), including seeds >= 2**31, which
reach the JAX kernel through an int32 (``integrate_pallas._prep``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

from tpu_montecarlo.ops import integrate_pallas as jpl
from tpu_montecarlo.ops.qmc import _pcg_mix
from tpu_montecarlo_torch.ops import integrate_kernel as tk
from tpu_montecarlo_torch.ops.qmc import pcg_mix

SEEDS = [0, 1, 42, 2**31 - 1, 2**31 + 5, 2**32 - 1]
SHAPE = (16, 128)


def _jax_rng(seed: int, pid: int):
    rng = jpl.CounterRng()
    # The kernel receives the seed as int32 (two's complement of the
    # uint32 word) and the program id as int32.
    seed_i32 = np.array(seed, np.uint32).view(np.int32)
    rng.seed(jnp.int32(seed_i32), jnp.int32(pid))
    return rng


def test_pcg_mix_bit_equal():
    rs = np.random.default_rng(0)
    words = np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
        rs.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32),
    ])
    want = np.asarray(_pcg_mix(jnp.asarray(words)))
    got = pcg_mix(torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_rng_bits_bit_equal(seed):
    for pid in (0, 1, 63):
        want_rng = _jax_rng(seed, pid)
        got_rng = tk.CounterRng(seed, pid)
        for counter in (0, 7, 511):
            for tag in (0, 1):
                want = np.asarray(
                    want_rng.bits(SHAPE, jnp.int32(counter), tag)
                ).astype(np.int64)
                got = got_rng.bits(SHAPE, counter, tag).numpy()
                np.testing.assert_array_equal(got, want)


def test_counter_rng_negative_seed_word_wraps():
    # An int32 seed of -1 is the uint32 word 2**32 - 1, as in the kernel.
    a = tk.CounterRng(-1, 3).bits(SHAPE, 5, 1)
    b = tk.CounterRng(2**32 - 1, 3).bits(SHAPE, 5, 1)
    assert torch.equal(a, b)


def test_counter_rng_batched_streams():
    """A tensor of program ids gives one stream per id, each equal to the
    scalar stream (the plain version draws many tiles at once)."""
    pids = torch.tensor([0, 5, 9], dtype=torch.int64)
    counters = torch.tensor([3, 0, 511], dtype=torch.int64)
    batch = tk.CounterRng(42, pids).bits(SHAPE, counters, 1)
    assert batch.shape == (3, *SHAPE)
    for i in range(3):
        want = np.asarray(
            _jax_rng(42, int(pids[i])).bits(SHAPE, jnp.int32(counters[i]), 1)
        ).astype(np.int64)
        np.testing.assert_array_equal(batch[i].numpy(), want)


@pytest.mark.parametrize("form", ["open01", "halfopen01"])
@pytest.mark.parametrize("seed", [42, 2**31 + 5])
def test_uniforms_bit_equal(form, seed):
    jfn = getattr(jpl, f"_uniform_{form}")
    tfn = getattr(tk, f"uniform_{form}")
    for pid, counter, tag in [(0, 0, 0), (2, 17, 1), (40, 300, 0)]:
        want = np.asarray(
            jfn(_jax_rng(seed, pid), SHAPE, jnp.int32(counter), tag)
        )
        got = tfn(tk.CounterRng(seed, pid), SHAPE, counter, tag).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        if form == "open01":
            assert got.min() > 0.0 and got.max() <= 1.0
        else:
            assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("n_samples", [1, 32768, 200_704, 5_000_000, 2**30])
def test_plan_grid_matches_jax_grid(n_samples):
    """The port's grid is the JAX kernel's: plan_pallas_grid at 256 rows
    plus the unroll rounding of build_integrate_fn_pallas."""
    programs, loops, _ = jpl.plan_pallas_grid(n_samples, tk.BLOCK_ROWS)
    unroll = min(jpl.UNROLL_BLOCKS, loops)
    loops = -(-loops // unroll) * unroll
    grid = tk.plan_grid(n_samples)
    assert (grid.programs, grid.loops) == (programs, loops)
    assert grid.actual_samples == programs * loops * jpl.BLOCK_ELEMS
    assert grid.actual_samples >= n_samples
