"""The port's sampling transforms against the JAX package's and float64
scipy, on one numpy grid of kernel uniforms.

The only per-sample difference between the two packages is erfinv: JAX's
float32 ``lax.erf_inv`` is off by up to ~2.2e-5 near |z| = 3.76, torch's
``erfinv`` by ~4.5e-7, so each is held to float64 scipy on the same
float32 argument ``2u - 1``, and the two to each other within the sum.
"""

import numpy as np
import pytest
import scipy.special

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

from tpu_montecarlo import sampling as jsamp
from tpu_montecarlo.ops import integrate_pallas as jpl
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo_torch import sampling as tsamp
from tpu_montecarlo_torch.ops import integrate_kernel as tk

_INV = np.float32(2.0**-24)
_LO = np.float32(1e-7)
_HI = np.float32(1.0 - 1e-7)


def _u_grid(open_form: bool) -> np.ndarray:
    """Kernel uniforms m * 2**-24 ((m + 1) for the open form): both tails
    in full, a stride through the middle, and the clamp edges."""
    m = np.concatenate([
        np.arange(0, 1 << 16),
        np.arange(1 << 16, (1 << 24) - (1 << 16), 97),
        np.arange((1 << 24) - (1 << 16), 1 << 24),
    ]).astype(np.int64)
    u = ((m + 1) if open_form else m).astype(np.float32) * _INV
    edges = np.array(
        [0.0, 1.0, _LO, np.nextafter(_LO, np.float32(0)),
         np.nextafter(_LO, np.float32(1)), _HI,
         np.nextafter(_HI, np.float32(1)), 0.5],
        np.float32,
    )
    return np.concatenate([u.astype(np.float32), edges])


def test_normal_from_u01_against_scipy_and_jax():
    u = _u_grid(open_form=False)
    arg = (np.float32(2.0) * np.clip(u, _LO, _HI) - np.float32(1.0))
    ref = np.sqrt(2.0) * scipy.special.erfinv(arg.astype(np.float32).astype(np.float64))
    got = tsamp.normal_from_u01(torch.from_numpy(u)).numpy()
    want = np.asarray(jax.jit(jsamp.normal_from_u01)(u))
    assert got.dtype == np.float32
    assert np.all(np.isfinite(got))
    port_err = np.abs(got.astype(np.float64) - ref).max()
    jax_err = np.abs(want.astype(np.float64) - ref).max()
    assert port_err < 1e-6, port_err  # measured 4.6e-7
    assert jax_err < 3e-5, jax_err  # measured 2.2e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # The clamp cuts both tails at ~5.2 sigma.
    assert 5.1 < got.max() < 5.3 and -5.3 < got.min() < -5.1


def test_exponential_transform_against_scipy_and_jax():
    u = _u_grid(open_form=True)
    ref = -np.log(np.maximum(u.astype(np.float64), np.float64(_LO)))
    got = tsamp.exponential_from_u01(torch.from_numpy(u)).numpy()
    want = np.asarray(jax.jit(lambda v: -jnp.log(jnp.maximum(v, 1e-7)))(u))
    assert got.dtype == np.float32
    # float32 log is within half an ulp of the result (<= 9.5e-7 at 16.1).
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


def test_next_below_f32_bit_equal():
    rs = np.random.default_rng(3)
    hi = np.concatenate([
        # Normal numbers only: JAX's CPU backend flushes subnormal
        # inputs to zero, torch and the CUDA kernel keep them.
        np.array([0.0, -0.0, 1.0, -1.0, 2.0, 2e-38, -2e-38, 3.4e38,
                  -3.4e38, 0.5, 1e-7], np.float32),
        rs.standard_normal(512).astype(np.float32) * 100,
    ])
    got = tsamp.next_below_f32(torch.from_numpy(hi)).numpy()
    want = np.asarray(jsamp.next_below_f32(hi))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    nonzero = hi != 0
    assert np.all(got[nonzero] < hi[nonzero])
    assert np.all(got[nonzero] == np.nextafter(hi[nonzero], np.float32(-np.inf)))


@pytest.mark.parametrize(
    "kind,p1,p2",
    [
        ("UNIFORM", -1.0, 2.0),
        # A narrow range whose f32 rounding lands on the open bound.
        ("UNIFORM", 1.0, 1.0000001),
        ("NORMAL", 0.5, 1.5),
        ("EXPONENTIAL", 2.0, 0.0),
    ],
)
def test_sample_subblocks_match_jax(kind, p1, p2):
    """One tile of samples, family transform included, as the JAX kernel
    draws it in interpret mode: uniform bit-equal, exponential within one
    ulp (two float32 logs), normal within the erfinv difference."""
    rows = 16
    seed, pid, counter = 42, 3, 9
    jrng = jpl.CounterRng()
    jrng.seed(jnp.int32(seed), jnp.int32(pid))
    want = jpl._sample_subblocks(
        JKind[kind], jnp.float32(p1), jnp.float32(p2), jrng,
        jnp.int32(counter), rows=rows,
    )
    got = tk.sample_subblocks(
        tsamp.DistKind[kind], torch.tensor(p1, dtype=torch.float32),
        torch.tensor(p2, dtype=torch.float32), tk.CounterRng(seed, pid),
        counter, rows=rows,
    )
    assert len(got) == len(want) == (2 if kind == "NORMAL" else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        if kind == "NORMAL":
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5 * p2)
        elif kind == "EXPONENTIAL":
            np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=0)
        else:
            np.testing.assert_array_equal(g, w)
        if kind == "UNIFORM":
            assert g.min() >= np.float32(p1) and g.max() < np.float32(p2)
