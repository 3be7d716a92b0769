"""The port's multi-dimensional ``integrate`` slice against the JAX package.

The port's plain PyTorch version draws, tile for tile, the samples of the
JAX kernel ``build_integrate_nd_pallas`` in interpret mode (its
``CounterRng`` stream, or its Sobol net), wherever that kernel keeps
256-row blocks; every shape here asserts that it does.  So:

* uniforms and Sobol words are bit-equal;
* uniform and exponential samples agree within 4 ulp; normal samples
  within 4 ulp of z plus what one step of the uniforms (2**-24) moves z
  through the quantile (its slope is 1 / phi(z)), times the std.  torch's
  and XLA's ``erfinv`` differ by up to 2.2e-5 (91 ulp, at z = -3.76) over
  all 2**24 uniforms the stream can draw: XLA's float32 ``erf_inv``
  rounds ``1 - x*x`` near |x| = 1, which moves z as an error of at most
  2**-27 in u would.  Measured at 0.95 of 2**-22 max(1, |z|) + 2**-27 /
  phi(z), so the tolerance holds a margin of about 4;
* means agree within 1e-6 + 1e-6 |mean| (float32 summation order over up
  to 2**20 values of order 1; measured up to 1.2e-10);
* error bars within rel 1e-4: they come from the same squares, up to
  summation order and the pilot (a mean over a 1,024-point grid, whose
  last bits differ with the reduction order); ``sqs / n - dlt**2``
  cancels at most a few digits here (measured: equal to 8 digits);
* randomized-QMC error bars, the spread of a few rotations' means, within
  the means' own tolerance, absolute: the rotations agree to ~1e-5
  relative, so a last-bit difference in one mean moves their spread by
  up to 0.3 % (measured 2.4e-8 on a spread of 8.7e-6).

Sizes stay at or below 2**20 samples.  The CUDA kernel is held against
the plain version in ``test_torch_cuda.py``.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.ops import qmc as jqmc
from tpu_montecarlo.ops.integrate_nd_pallas import (
    _draw_dim,
    _draw_dim_pair,
    build_integrate_nd_pallas,
    pick_nd_rows,
)
from tpu_montecarlo.ops.integrate_pallas import (
    CounterRng as JCounterRng,
    _qmc_pos,
    _uniform_halfopen01,
    _uniform_open01,
)
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops import qmc
from tpu_montecarlo_torch.ops.integrate_kernel import plan_grid
from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
    IntegrateNdProgram,
    NdConfig,
    finish_stderr,
    integrate_nd_cuda,
    integrate_nd_rows,
    integrate_nd_reference,
    nd_samples,
    nd_uniforms,
    pilot_row,
    qmc_seg_bits,
)
from tpu_montecarlo_torch.sampling import DistKind
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "tpu_montecarlo_torch" / "csrc"

CPU_CHUNK = 1 << 22  # the JAX package's max_chunk_elems off the TPU
THREADS = 1024
MEAN_ATOL = MEAN_RTOL = 1e-6
STDERR_RTOL = 1e-4

# c9 (benchmarks/run_all.py:338-354): N(0,1) x U(0,1) x Exp(2).
C9_FNS = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]
C9_DISTS = (("normal", 0.0, 1.0), ("uniform", 0.0, 1.0), ("exponential", 2.0))
# c9c (run_all.py:355-371): U(0,1)^2 under Sobol.
C9C_FNS = [lambda x, y: np.exp(x) * np.exp(y)]
C9C_DISTS = (("uniform", 0.0, 1.0), ("uniform", 0.0, 1.0))
# Four dimensions, every family, K=3.
MIXED_FNS = [
    lambda a, b, c, d: a + b * c - d,
    lambda a, b, c, d: (a > 0.5) * b + c * d,
    lambda a, b, c, d: abs(a - c) * np.exp(-b) + d * d,
]
MIXED_DISTS = (
    ("normal", 0.5, 1.5), ("exponential", 1.5), ("normal", -1.0, 0.5),
    ("uniform", -1.0, 2.0),
)


def _dists(pkg, spec):
    make = {
        "normal": pkg.Distribution.normal,
        "uniform": pkg.Distribution.uniform,
        "exponential": pkg.Distribution.exponential,
    }
    return [make[name](*args) for name, *args in spec]


def _specs(spec):
    specs = [j_dist_spec_of(d) for d in _dists(jmc, spec)]
    kinds = tuple(int(s.kind) for s in specs)
    return kinds, np.stack([s.params for s in specs])


def _close(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64),
        rtol=rtol, atol=atol,
    )


# -- Sobol and the seed words, bit for bit ------------------------------------


def test_sobol_direction_numbers_match_all_dims():
    for dim in range(qmc.SOBOL_MAX_DIMS):
        np.testing.assert_array_equal(
            qmc.sobol_direction_numbers(dim), jqmc.sobol_direction_numbers(dim)
        )
    with pytest.raises(ValueError, match="32 dimensions"):
        qmc.sobol_direction_numbers(qmc.SOBOL_MAX_DIMS)


def _words(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def test_bitrev_and_shifts_bit_equal():
    w = _words(1, 4096)
    t = torch.from_numpy(w.astype(np.int64))
    np.testing.assert_array_equal(
        qmc.bitrev32(t).numpy().astype(np.uint32),
        np.asarray(jqmc.bitrev32(jnp.asarray(w))),
    )
    segs = _words(2, 4096) % 9  # segment 0 keeps the shift
    for tag in (1, 2, 17, 32):
        got = qmc.derive_shift(t, tag)
        np.testing.assert_array_equal(
            got.numpy().astype(np.uint32),
            np.asarray(jqmc.derive_shift(jnp.asarray(w), tag)),
        )
        np.testing.assert_array_equal(
            qmc.derive_segment_shift(got, torch.from_numpy(segs.astype(np.int64)))
            .numpy().astype(np.uint32),
            np.asarray(
                jqmc.derive_segment_shift(
                    jqmc.derive_shift(jnp.asarray(w), tag), jnp.asarray(segs)
                )
            ),
        )
    # Python-int seeds wrap as the kernel's int32 seed word does.
    for seed in (-7, -1, 0, 42, (1 << 31) + 5, (1 << 32) - 1):
        assert int(qmc.derive_shift(seed, 3)) == int(
            jqmc.derive_shift(jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32), 3)
        )


@pytest.mark.parametrize("dim", [0, 1, 5, 16, 31])
def test_sobol_split_form_equals_whole_index(dim):
    v = qmc.sobol_direction_numbers(dim)
    blocks = torch.from_numpy((_words(dim, 64) >> 15).astype(np.int64))
    pos = torch.from_numpy((_words(dim + 100, 512) & 0x7FFF).astype(np.int64))
    whole = qmc.sobol_bits((blocks[:, None] << 15) | pos[None], v)
    split = qmc.sobol_base_bits(blocks, v, 15)[:, None] ^ qmc.sobol_offset_bits(pos, v, 15)[None]
    assert torch.equal(whole, split)
    np.testing.assert_array_equal(
        whole.numpy().astype(np.uint32),
        np.asarray(
            jqmc.sobol_bits(
                jnp.asarray(((blocks[:, None] << 15) | pos[None]).numpy().astype(np.uint32)),
                v,
            )
        ),
    )
    if dim == 0:  # dimension 0 is the radical inverse
        assert torch.equal(whole, qmc.bitrev32((blocks[:, None] << 15) | pos[None]))


# -- the plan ------------------------------------------------------------------

PLAN_NS = [1, 1000, 32_768, 32_769, 262_145, 1 << 20, 10_000_000, 100_000_001,
           (1 << 30) + 1, 1_000_000_000, 3_000_000_000]


@pytest.mark.parametrize("method", ["mc", "antithetic"])
def test_plan_matches_jax_actual_samples(method):
    traced = tuple(j_trace(f, 3) for f in C9_FNS)
    kinds, _ = _specs(C9_DISTS)
    for n in PLAN_NS:
        plan = j_plan(n, None, max_chunk_elems=CPU_CHUNK)
        run = build_integrate_nd_pallas(
            traced, kinds, plan, interpret=True, method=method
        )
        assert run.block_rows == 256
        grid = plan_grid(plan.actual_samples, method)
        assert grid.actual_samples == run.actual_samples, n
        assert grid.actual_samples >= n


def test_qmc_segments_only_past_two_to_the_32():
    assert qmc_seg_bits(plan_grid(1 << 31, "qmc")) is None
    # The plan rounds to whole programs of 512 tiles: 255 stay below 2**32
    # points, 256 reach it.
    assert qmc_seg_bits(plan_grid(255 * 512 * 32_768, "qmc")) is None
    assert qmc_seg_bits(plan_grid(255 * 512 * 32_768 + 1, "qmc")) == 17
    with pytest.raises(ValueError, match="exceeds int32"):
        qmc_seg_bits(plan_grid(1 << 46, "qmc"))


# -- one tile's draws against the JAX kernel's -----------------------------------


def _samples_close(kind, mean, std, got, want):
    """Uniform and exponential samples within 4 ulp; normal ones within
    4 ulp of z plus one uniform step through the quantile, times the std,
    plus 2 ulp for the affine map (erfinv differs between torch and XLA;
    module docstring)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    size = np.maximum(np.abs(got), np.abs(want))
    err = np.abs(got.astype(np.float64) - want)
    if kind == DistKind.NORMAL:
        z = (want.astype(np.float64) - mean) / std
        phi = np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)
        tol = std * (2.0**-21 * np.maximum(1.0, np.abs(z)) + 2.0**-24 / phi)
        tol += 2 * np.spacing(size)
    else:
        tol = 4 * np.spacing(size)
    worst = np.unravel_index(np.argmax(err / tol), err.shape)
    assert np.all(err <= tol), (worst, got[worst], want[worst], tol[worst])


@pytest.mark.parametrize("seed", [42, -7, (1 << 31) + 9])
def test_tile_uniforms_and_samples_match_jax(seed):
    kinds, params = _specs(MIXED_DISTS)
    grid = plan_grid(1 << 22)
    pid, blk = 3, 5
    tiles = torch.tensor([pid * grid.loops + blk])
    rng = JCounterRng()
    rng.seed(jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32).astype(jnp.int32), pid)
    for j, kind in enumerate(kinds):
        for open01, jdraw in ((False, _uniform_halfopen01), (True, _uniform_open01)):
            got = nd_uniforms("mc", seed, grid, tiles, j, open01)[0].numpy()
            want = np.asarray(jdraw(rng, (256, 128), blk, j))
            np.testing.assert_array_equal(got, want)
    cfg = NdConfig(kinds)
    xs = nd_samples(cfg, torch.tensor(params), seed, grid, tiles)
    pair = nd_samples(NdConfig(kinds, "antithetic"), torch.tensor(params), seed, grid, tiles)
    for j, kind in enumerate(kinds):
        get_u = lambda open01, j=j: (  # noqa: E731
            _uniform_open01 if open01 else _uniform_halfopen01
        )(rng, (256, 128), blk, j)
        p1, p2 = jnp.float32(params[j, 0]), jnp.float32(params[j, 1])
        mean, std = float(p1), float(p2)
        _samples_close(kind, mean, std, xs[j][0].numpy(), _draw_dim(kind, p1, p2, get_u))
        a, b = _draw_dim_pair(kind, p1, p2, get_u)
        _samples_close(kind, mean, std, pair[0][j][0].numpy(), a)
        _samples_close(kind, mean, std, pair[1][j][0].numpy(), b)


@pytest.mark.parametrize("segmented", [False, True], ids=["one-segment", "segments"])
def test_tile_sobol_uniforms_match_jax(segmented):
    grid = plan_grid((1 << 33) if segmented else (1 << 24), "qmc")
    seg_bits = qmc_seg_bits(grid)
    assert (seg_bits is not None) == segmented
    blocks = [0, 7, (1 << 17) + 3, 3 * (1 << 17) + 11] if segmented else [0, 7, 511]
    seed = (1 << 31) + 77
    for j in (0, 1, 2, 31):
        v = jqmc.sobol_direction_numbers(j)
        shift0 = jqmc.derive_shift(jnp.asarray(seed, jnp.uint32), j + 1)
        offs = jqmc.sobol_offset_bits(_qmc_pos(256), v, 15)
        for b in blocks:
            bb, shift = b, shift0
            if seg_bits is not None:
                bb, shift = b & ((1 << 17) - 1), jqmc.derive_segment_shift(shift0, b >> 17)
            base = jqmc.sobol_base_bits(jnp.int32(bb), v, 15)
            for open01 in (False, True):
                want = np.asarray(jqmc.sobol_u01_split(base, offs, shift, open01=open01))
                got = nd_uniforms("qmc", seed, grid, torch.tensor([b]), j, open01)[0]
                np.testing.assert_array_equal(got.numpy(), want)


# -- the plain version against the interpret-mode JAX kernel -----------------------

REF_CASES = {
    "c9-mc": (C9_FNS, C9_DISTS, "mc", False),
    "c9-antithetic": (C9_FNS, C9_DISTS, "antithetic", False),
    "c9-qmc": (C9_FNS, C9_DISTS, "qmc", False),
    "c9-mc-stderr": (C9_FNS, C9_DISTS, "mc", True),
    "c9-antithetic-stderr": (C9_FNS, C9_DISTS, "antithetic", True),
    "c9c-qmc": (C9C_FNS, C9C_DISTS, "qmc", False),
    "mixed-mc": (MIXED_FNS, MIXED_DISTS, "mc", False),
    "mixed-antithetic": (MIXED_FNS, MIXED_DISTS, "antithetic", False),
    "mixed-mc-stderr": (MIXED_FNS, MIXED_DISTS, "mc", True),
}


def _port_run(fns, kinds, params, seed, grid, method, with_stderr):
    d = len(kinds)
    program = IntegrateNdProgram(tuple(tm.trace_function(f, d) for f in fns), kinds)
    cfg = NdConfig(kinds, method, with_stderr)
    p = torch.tensor(params)
    n = float(np.float32(grid.actual_samples))
    if not with_stderr:
        return (integrate_nd_reference(program.torch_fns, cfg, p, seed, grid) / n).numpy()
    pilot = pilot_row(program.torch_fns, kinds, p)
    sums, sqs = integrate_nd_reference(program.torch_fns, cfg, p, seed, grid, pilot)
    mean, se = finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
    return mean.numpy(), se.numpy()


@pytest.mark.parametrize("case", list(REF_CASES))
def test_plain_version_matches_jax_interpret_kernel(case):
    fns, dists, method, with_stderr = REF_CASES[case]
    kinds, params = _specs(dists)
    d, k = len(kinds), len(fns)
    n = 1 << 19
    plan = j_plan(n, THREADS, max_chunk_elems=CPU_CHUNK)
    grid_samples = -(-plan.actual_samples // 2) if method == "antithetic" else plan.actual_samples
    assert pick_nd_rows(k, d, grid_samples, with_stderr=with_stderr,
                        kinds=kinds, method=method) == 256
    run = build_integrate_nd_pallas(
        tuple(j_trace(f, d) for f in fns), kinds, plan, interpret=True,
        method=method, with_stderr=with_stderr,
    )
    grid = plan_grid(make_integrate_plan(n, THREADS).actual_samples, method)
    assert grid.actual_samples == run.actual_samples
    for seed in (42, -3):
        want = run(np.int32(seed), params)
        got = _port_run(fns, kinds, params, seed, grid, method, with_stderr)
        if with_stderr:
            _close(got[0], want[0])
            _close(got[1], want[1], rtol=STDERR_RTOL, atol=0.0)
            assert np.all(got[1] > 0)
        else:
            assert got.shape == (k,) and got.dtype == np.float32
            _close(got, want)


# -- the public path -------------------------------------------------------------


def _public(pkg, integ, fns, dists, **kw):
    return integ.integrate(fns, _dists(pkg, dists), **kw)


@pytest.mark.parametrize(
    "fns,dists,kw",
    [
        (C9_FNS, C9_DISTS, dict(method="mc")),
        (C9_FNS, C9_DISTS, dict(method="antithetic", return_stderr=True)),
        (C9_FNS, C9_DISTS, dict(method="qmc")),
        (C9C_FNS, C9C_DISTS, dict(method="qmc", return_stderr=True, qmc_rotations=4)),
        (MIXED_FNS, MIXED_DISTS, dict(method="mc", return_stderr=True, seed=(1 << 31) + 1)),
    ],
    ids=["c9-mc", "c9-antithetic-stderr", "c9-qmc", "c9c-rqmc", "mixed-mc-stderr"],
)
def test_public_path_matches_jax_pallas_backend(fns, dists, kw):
    kw = dict(dict(n_samples=1 << 18, seed=42), **kw)
    want = _public(jmc, jmc.MonteCarloIntegrator(backend="pallas"), fns, dists, **kw)
    got = _public(tm, tm.MonteCarloIntegrator(device="cpu"), fns, dists, **kw)
    assert got.values.dtype == np.float64 and got.values.shape == (len(fns),)
    assert got.n_samples == kw["n_samples"] and got.n_functions == len(fns)
    _close(got.values, want.values)
    if kw.get("method") == "qmc" and kw.get("return_stderr"):
        atol = MEAN_ATOL + MEAN_RTOL * np.abs(want.values)
        assert np.all(np.abs(got.stderr - want.stderr) <= atol)
    elif kw.get("return_stderr"):
        _close(got.stderr, want.stderr, rtol=STDERR_RTOL, atol=0.0)
    else:
        assert got.stderr is None


def test_rqmc_beats_plain_mc_on_c9c():
    # rQMC: the mean of rotations of the net, and their spread; far below
    # the plain-MC error bar at the same count, and near (e - 1)^2.
    integ = tm.MonteCarloIntegrator(device="cpu")
    dists = _dists(tm, C9C_DISTS)
    q = integ.integrate(C9C_FNS, dists, n_samples=1 << 20, method="qmc",
                        return_stderr=True, qmc_rotations=8)
    m = integ.integrate(C9C_FNS, dists, n_samples=1 << 20, return_stderr=True)
    exact = (np.e - 1.0) ** 2
    assert abs(q.values[0] - exact) < 6 * q.stderr[0] + 1e-6
    assert abs(m.values[0] - exact) < 6 * m.stderr[0]
    assert q.stderr[0] < m.stderr[0] / 10


def test_seeds_and_cache(program_cache):
    integ = tm.MonteCarloIntegrator(device="cpu")
    dists = _dists(tm, C9_DISTS)
    r1 = integ.integrate(C9_FNS, dists, n_samples=100_000, seed=7)
    size = len(program_cache._store)
    r2 = integ.integrate(list(C9_FNS), dists, n_samples=100_000, seed=7)
    assert len(program_cache._store) == size
    r3 = integ.integrate(C9_FNS, dists, n_samples=100_000, seed=8)
    np.testing.assert_array_equal(r1.values, r2.values)
    assert r1.values[0] != r3.values[0]
    # Another family tuple is another program (the families are compiled in).
    integ.integrate(C9_FNS, dists[::-1], n_samples=1000)
    assert len(program_cache._store) == size + 1
    for pkg, i in ((tm, integ), (jmc, jmc.MonteCarloIntegrator(backend="pallas"))):
        with pytest.raises(OverflowError):
            i.integrate(C9_FNS, _dists(pkg, C9_DISTS), n_samples=1000, seed=-1)


def _first_of_two(x, y):
    return x


def _first_of_33(x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11, x12, x13,
                 x14, x15, x16, x17, x18, x19, x20, x21, x22, x23, x24, x25,
                 x26, x27, x28, x29, x30, x31, x32):
    return x0


ARG_ERRORS = {
    "method": (2, [_first_of_two], dict(method="sobol")),
    "rotations": (2, [_first_of_two], dict(method="qmc", return_stderr=True, qmc_rotations=1)),
    "sobol-dims": (33, [_first_of_33], dict(method="qmc")),
}


@pytest.mark.parametrize("case", list(ARG_ERRORS))
def test_argument_errors_match_jax(case):
    dims, fns, kw = ARG_ERRORS[case]

    def call(pkg, integ):
        dists = [pkg.Distribution.uniform(0.0, 1.0)] * dims
        return integ.integrate(fns, dists, n_samples=1000, **kw)

    with pytest.raises(ValueError) as want:
        call(jmc, jmc.MonteCarloIntegrator(backend="pallas"))
    with pytest.raises(ValueError) as got:
        call(tm, tm.MonteCarloIntegrator(device="cpu"))
    assert str(got.value) == str(want.value)


def test_arity_mismatch_raises_trace_error():
    u = [tm.Distribution.uniform(0.0, 1.0)] * 2
    with pytest.raises(tm.TraceError, match="takes 3 arguments, got 2"):
        tm.integrate([lambda x, y, z: x], u, n_samples=1000, device="cpu")


# -- what the slice does not take ---------------------------------------------------


def _plus(c):
    return lambda x, y: x + c


def _while_pdf(x):
    y = 0.0
    while y < 1.0:
        y = y + 1.0
    return 0.5 * y if abs(x) < 1.0 else 0.0


def test_out_of_scope_options_name_their_roadmap_items():
    """What still raises, naming its item; what raised here before and
    runs since (more than 127/128/126 functions in passes, nd control
    variates) is checked by test_wide_and_control_variate_options_run,
    and ``expectation_fn``, 1-D and nd, by tests/test_torch_expectation.py."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    u = tm.Distribution.uniform(0.0, 1.0)
    # A density with a while loop: the JAX package traces it; the port's
    # front end names item 3 rather than take the PDF-table fallback.
    untraceable = tm.Distribution(tm.DistributionType.CUSTOM, {}, _while_pdf)
    cases = {
        r"item 12 ": lambda: tm.MonteCarloIntegrator(device="cpu", mesh="auto"),
        r"item 3 ": lambda: integ.integrate_importance_sampling([lambda x: x], untraceable, u),
    }
    for item, case in cases.items():
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1 " + item):
            case()


def test_wide_and_control_variate_options_run():
    """The cases the test above raised on before they were ported: nd
    MCMC over 129 functions in a seed-batched handle, nd integrate over
    129, tempering over 127 (in passes of at most 127, 128 and 126), and
    nd control variates (E[xy] = 1/4 over U(0, 1)^2, the control its own
    integrand: exact)."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    u = tm.Distribution.uniform(0.0, 1.0)
    f2 = [lambda x, y: x * y]
    wide = [_plus(float(c)) for c in range(129)]
    wide1 = [(lambda c: lambda x: x + c)(float(c)) for c in range(127)]
    short = dict(n_steps=10, n_burnin=2)
    nd_handle = integ.compile_mcmc(wide, [u, u], [u, u], seed_batch=4,
                                   **short)([1, 2, 3, 4])[0].numpy()
    nd_values = integ.integrate(wide, [u, u], n_samples=1000).values
    pt_handle = integ.compile_mcmc(wide1, u, u, temperatures=[1.0, 2.0],
                                   **short)(5)[0].numpy()
    for values, k in ((nd_handle, 129), (nd_values, 129), (pt_handle, 127)):
        assert values.shape[-1] == k
        shift = values - values[..., :1]
        np.testing.assert_allclose(shift, np.broadcast_to(
            np.arange(float(k)), shift.shape), atol=1e-3)
    cv = integ.integrate(f2, [u, u], n_samples=1000,
                         control_variates=[(f2[0], 0.25)])
    assert abs(cv.values[0] - 0.25) < 1e-6


def test_the_former_refusals_run():
    """compile_importance_sampling over sequences and a seed-batched nd
    compile_integrate, which raised before the serving handles."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    u = tm.Distribution.uniform(0.0, 1.0)
    f2 = [lambda x, y: x * y]
    is_prog = integ.compile_importance_sampling(f2, [u, u], [u, u],
                                                n_samples=1 << 16)
    want = integ.integrate_importance_sampling(f2, [u, u], [u, u],
                                               n_samples=1 << 16, seed=5)
    np.testing.assert_array_equal(is_prog(5).numpy(), want.values)
    prog = integ.compile_integrate(f2, [u, u], n_samples=1 << 16, seed_batch=4)
    out = prog([1, 2, 3, 4])
    assert out.shape == (4, 1) and out.dtype == torch.float32
    assert torch.equal(out[2], integ.compile_integrate(f2, [u, u],
                                                       n_samples=1 << 16)(3))


def test_missing_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.integrate(C9_FNS, _dists(tm, C9_DISTS))


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    kinds, params = _specs(C9_DISTS)
    program = IntegrateNdProgram(tuple(tm.trace_function(f, 3) for f in C9_FNS), kinds)
    grid = plan_grid(100_000, "antithetic")
    p = torch.tensor(params)
    cfg = NdConfig(kinds, "antithetic", with_stderr=True)
    pilot = pilot_row(program.torch_fns, kinds, p)
    before = integrate_nd_cuda.launches
    got = integrate_nd_cuda(program, cfg, p, 3, grid, pilot)
    want = integrate_nd_reference(program.torch_fns, cfg, p, 3, grid, pilot)
    assert got.shape == (2, 2) and torch.equal(got, want)
    assert integrate_nd_cuda.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="float32"):
        integrate_nd_cuda(program, cfg, p.double(), 3, grid, pilot)
    with pytest.raises(ValueError, match="pilot"):
        integrate_nd_cuda(program, cfg, p, 3, grid)
    with pytest.raises(ValueError, match="built for"):
        integrate_nd_cuda(program, NdConfig(kinds[::-1]), p, 3, grid)
    with pytest.raises(ValueError, match="no nd integrate kernel"):
        integrate_nd_cuda(program, NdConfig(kinds), p.to("meta"), 3, grid)
    with pytest.raises(ValueError, match="no nd integrate kernel"):
        integrate_nd_rows(program, cfg, p, 3, grid, pilot)  # rows: card only
    assert NdConfig(kinds, "qmc", with_stderr=True).with_stderr  # as JAX's
    with pytest.raises(ValueError, match="arguments"):
        IntegrateNdProgram((tm.trace_function(lambda x, y: x, 2),), kinds)


def test_pilot_row_matches_jax_grid():
    # The pilot as the JAX kernel builds it: per-dimension quantile grids,
    # the uniform one unclamped, the exponential one -log(u)/lambda.
    kinds, params = _specs(MIXED_DISTS)
    fns = tuple(tm.trace_function(f, 4) for f in MIXED_FNS)
    got = pilot_row(IntegrateNdProgram(fns, kinds).torch_fns, kinds, torch.tensor(params))
    base = (np.arange(1024, dtype=np.float32) + np.float32(0.5)) / np.float32(1024)
    xs = []
    for j, kind in enumerate(kinds):
        u = np.mod(base + np.float32(j) * np.float32(0.3819660113), np.float32(1.0))
        u = np.clip(u, np.float32(1e-7), np.float32(1 - 1e-7)).astype(np.float32)
        p1, p2 = params[j]
        if kind == DistKind.UNIFORM:
            xs.append(p1 + u * (p2 - p1))
        elif kind == DistKind.NORMAL:
            xs.append(p1 + p2 * np.asarray(jmc.sampling.normal_from_u01(jnp.asarray(u))))
        else:
            xs.append(-np.log(u) / p1)
    want = [np.mean(np.asarray(f(*xs), np.float64)) for f in MIXED_FNS]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# -- the Sobol header, compiled on the host -------------------------------------------

_SOBOL_SHIM = r"""
#include <cstdint>
#include <cstring>
#include <math.h>
#define __device__
#define __forceinline__ inline
static inline float erfinvf(float x) { return x; }
static inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
#include "sobol.cuh"
// The nd kernel's split of index tile * 2^15 + thread + 256 * i.
extern "C" uint32_t kernel_mantissa(const uint32_t* v, uint32_t seed, uint32_t tag,
                                    int seg_bits, uint32_t tile, uint32_t thread,
                                    uint32_t i) {
  uint32_t b = tile, seg = 0u;
  if (seg_bits >= 0) { seg = b >> seg_bits; b &= (1u << seg_bits) - 1u; }
  const uint32_t shift = tmc::derive_segment_shift(tmc::derive_shift(seed, tag), seg);
  const uint32_t word = tmc::sobol_xor<17>(v, b, 15) ^ tmc::sobol_xor<8>(v, thread, 0) ^
                        tmc::sobol_xor<7>(v, i, 8);
  return tmc::sobol_top24(word, shift) >> 8;
}
"""


def test_sobol_header_matches_port(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    (tmp_path / "shim.cpp").write_text(_SOBOL_SHIM)
    so = tmp_path / "libsobol.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
         str(tmp_path / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.kernel_mantissa.restype = ctypes.c_uint32
    lib.kernel_mantissa.argtypes = [ctypes.c_void_p] + [ctypes.c_uint32] * 2 + [
        ctypes.c_int] + [ctypes.c_uint32] * 3
    seed = (1 << 31) + 5
    for segmented, tile in ((False, 9), (True, (1 << 17) * 2 + 9)):
        grid = plan_grid((1 << 33) if segmented else (1 << 22), "qmc")
        seg_bits = qmc_seg_bits(grid)
        for j in (0, 3):
            v = np.ascontiguousarray(qmc.sobol_direction_numbers(j))
            u = nd_uniforms("qmc", seed, grid, torch.tensor([tile]), j, False)[0]
            u = u.reshape(-1).numpy()
            for thread, i in ((0, 0), (5, 0), (255, 127), (17, 64)):
                m = lib.kernel_mantissa(
                    v.ctypes.data, seed, j + 1, -1 if seg_bits is None else seg_bits,
                    tile, thread, i,
                )
                assert np.float32(m) * np.float32(2.0 ** -24) == u[thread + 256 * i]


def test_imports_new_modules_with_jax_blocked(tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(
        "import sys\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "import tpu_montecarlo_torch as tm\n"
        "import tpu_montecarlo_torch.ops.integrate_nd_kernel\n"
        "import tpu_montecarlo_torch.ops.qmc\n"
        "u = tm.Distribution.uniform(0.0, 1.0)\n"
        "r = tm.integrate([lambda x, y: x * y], [u, u], n_samples=1 << 16,\n"
        "                 method='qmc', return_stderr=True, device='cpu')\n"
        "assert 'tpu_montecarlo' not in sys.modules\n"
        "print(r.values[0], r.stderr[0])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(script)], check=True, cwd=tmp_path, env=env,
        capture_output=True, text=True,
    )
    value, stderr = map(float, out.stdout.split())
    assert abs(value - 0.25) < 1e-3 and 0 < stderr < 1e-3


# -- the SASS counts behind chip_smoke.py's bounds ---------------------------------


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only numpy and the
    standard library at the top; its main needs a GPU)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


_LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119integrate_nd_kernelILi0ELb0EEEvjPKfPKjS3_ixiPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                       /* 0x0000000000007919 */
        /*0020*/                   I2F.U32.RP R2, R0 ;
        /*0030*/                   IADD3 R3, R2, 0x1, RZ ;
        /*0040*/                   MOV R4, RZ ;
        /*0050*/                   IMAD R5, R4, 0x2c9277b5, R3 ;
        /*0060*/                   LOP3.LUT R6, R5, 0xff, RZ, 0xc0, !PT ;
        /*0070*/                   I2F.U32 R7, R6 ;
        /*0080*/                   FSETP.GE.AND P1, PT, R7, 1, PT ;
        /*0090*/               @P1 BRA 0xc0 ;
        /*00a0*/                   MUFU.LG2 R8, R7 ;
        /*00b0*/                   FMUL R7, R8, 0.5 ;
        /*00c0*/                   FADD R9, R9, R7 ;
        /*00d0*/                   I2FP.F32.U32 R10, R5 ;
        /*00e0*/                   FFMA R9, R10, R10, R9 ;
        /*00f0*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0100*/                   ISETP.NE.AND P2, PT, R4, 0x80, PT ;
        /*0110*/               @P2 BRA 0x50 ;
        /*0120*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0130*/                   ISETP.NE.AND P3, PT, R2, 0x4, PT ;
        /*0140*/               @P3 BRA 0x30 ;
        /*0150*/                   SHFL.DOWN PT, R11, R9, 0x10, 0x1f ;
        /*0160*/                   FADD R12, R12, R11 ;
        /*0170*/                   ISETP.NE.AND P4, PT, R12, RZ, PT ;
        /*0180*/               @P4 BRA 0x160 ;
        /*0190*/                   EXIT ;
        /*01a0*/                   BRA 0x1a0;
\t\t..........
\t\tFunction : _ZN12_GLOBAL__N_111mcmc_kernelILi0EEEvv
        /*0000*/                   EXIT ;
"""


def test_sass_sample_loop_counts_the_cheapest_path():
    sass = _chip_smoke()

    funcs = sass.parse_functions(_LISTING)
    assert len(funcs) == 2
    nd = next(v for k, v in funcs.items() if "integrate_nd_kernel" in k)
    assert nd[3].opcode == "IADD3" and nd[9].predicated and nd[9].branch_target() == 0xC0
    loops = sass.loop_counts(nd)
    assert [(lp.start, lp.end) for lp in loops] == [
        (0x30, 0x140), (0x50, 0x110), (0x160, 0x180), (0x1A0, 0x1A0)
    ]
    # The cheapest path skips the MUFU arm; the outer (tile) loop counts
    # the inner body once, plus its own instructions.
    # The dependent chain on that path: IMAD R5 -> LOP3 R6 -> I2F R7 ->
    # FADD R9 -> FFMA R9 (5); the tile loop's IADD3 R3 feeds the IMAD (6).
    # The carried chain: FADD R9 -> FFMA R9 (2); R4 and R2 are counters.
    # IMAD takes a slot of the fma pipe and one of its IMAD half.
    assert loops[1].counts == {
        "fma": 4, "fmaheavy": 1, "alu": 3, "xu": 2, "issue": 11, "conversions": 2,
        "chain": 5, "carried": 2,
    }
    assert loops[0].counts == {
        "fma": 4, "fmaheavy": 1, "alu": 6, "xu": 2, "issue": 16, "conversions": 2,
        "chain": 6, "carried": 2,
    }
    assert loops[2].counts["chain"] == 2  # FADD R12 -> ISETP P4
    # Only the innermost drawing loop is a sample loop.
    assert sass.sample_loops(nd) == [loops[1]]
    most, least = sass.per_sample(_LISTING, "integrate_nd_kernel", 1)
    assert most == least == {
        "fma": 2.0, "fmaheavy": 0.5, "alu": 1.5, "xu": 1.0, "issue": 5.5,
        "conversions": 1.0,
        "chain": 2.5, "carried": 1.0,
    }
    with pytest.raises(ValueError, match="not a multiple"):
        sass.per_sample(_LISTING, "integrate_nd_kernel", 3)
    with pytest.raises(ValueError, match="no sample loop"):
        sass.per_sample(_LISTING, "mcmc_kernel", 1)
    assert sass.pipe_of("IMAD.WIDE.U32") == ("fma", "fmaheavy")
    assert sass.pipe_of("IMAD.MOV.U32") == ("fma", "fmaheavy")
    assert sass.pipe_of("FFMA") == sass.pipe_of("VIADD") == ("fma",)
    assert sass.pipe_of("FMNMX") == sass.pipe_of("LOP3.LUT") == ("alu",)
    assert sass.pipe_of("MUFU.EX2") == ("xu",)
    assert sass.pipe_of("LDS") == ()
    # A uniform's conversion is uint32 -> float32; logf's and sinf's
    # signed ones and integer division's .RP reciprocal are not.
    assert sass.is_uniform_conversion("I2FP.F32.U32")
    assert sass.is_uniform_conversion("I2F.U32")
    for op in ("I2FP.F32.S32", "I2F.U32.RP", "I2F.F64.S64", "F2I.U32.TRUNC"):
        assert not sass.is_uniform_conversion(op)


# Thread instructions per SM per clock of each pipe-probe mix
# (tools/pipe_probe.py) on an NVIDIA H100 80GB HBM3 at 700 W, at 1980 MHz:
# (the mix's own opcodes' rate, its loop control's ISETP, UIADD3 and BRA
# rate, and LDC where the loop loads a constant).
PROBE_READINGS = {
    "IMAD": ({"IMAD": 64.3}, 4.0, False),
    "IADD3": ({"IADD3": 52.8, "VIADD": 52.8}, 6.6, False),
    "LOP3": ({"LOP3": 59.6}, 3.7, False),
    "FFMA": ({"FFMA": 103.5}, 6.5, False),
    "FMNMX": ({"FMNMX": 60.6}, 3.8, False),
    "IMAD+IADD3": ({"IMAD": 62.7, "IADD3": 28.5}, 2.8, True),
    "IMAD+LOP3": ({"IMAD": 55.3, "LOP3": 55.3}, 3.5, False),
    "IMAD+FFMA": ({"IMAD": 44.8, "FFMA": 44.8}, 2.8, True),
    "LOP3+FFMA": ({"LOP3": 50.7, "FFMA": 50.7}, 3.2, True),
    "LOP3+FMNMX": ({"LOP3": 30.7, "FMNMX": 30.7}, 1.9, True),
    "FFMA+FMNMX": ({"FFMA": 40.9, "FMNMX": 40.9}, 2.6, True),
}


@pytest.mark.parametrize("mix", list(PROBE_READINGS))
def test_pipe_model_admits_every_probe_reading(mix):
    sass = _chip_smoke()
    ops, control, ldc = PROBE_READINGS[mix]
    rates = {**ops, "ISETP": control, "UIADD3": control, "BRA": control}
    if ldc:
        rates["LDC"] = control
    shares = sass.ceiling_shares(rates)
    assert max(shares.values()) <= 1 + sass.PROBE_TOLERANCE, shares
    if mix == "IMAD+FFMA":
        # Under two fma slots per IMAD this mix would need 134 of 128.
        assert (2 * ops["IMAD"] + ops["FFMA"]) / 128 > 1 + sass.PROBE_TOLERANCE
        assert shares["fma"] == pytest.approx((44.8 + 44.8) / 128)
        assert shares["fmaheavy"] == pytest.approx(44.8 / 64)


def test_sass_bound_takes_the_busiest_pipe():
    sass = _chip_smoke()

    counts = {"fma": 30.0, "fmaheavy": 10.0, "alu": 20.0, "xu": 4.0,
              "issue": 80.0}
    ms, pipe = sass.bound_ms(counts, 1e9, sms=132, clock_mhz=1000.0)
    # alu: 20e9 / (64 * 132 * 1e9) s, above fma's 30 / 128, its IMADs'
    # 10 / 64 and xu's 4 / 16; issue, 80 instructions, is a diagnostic
    # and not the bound.
    assert pipe == "alu" and ms == pytest.approx(20e9 / (64 * 132e9) * 1e3)
    # 22 IMADs of the 30 fma-pipe instructions: their half of the pipe
    # takes longer than the whole pipe's 30 / 128.
    heavy = {**counts, "fmaheavy": 22.0}
    ms, pipe = sass.bound_ms(heavy, 1e9, sms=132, clock_mhz=1000.0)
    assert pipe == "fmaheavy" and ms == pytest.approx(22e9 / (64 * 132e9) * 1e3)
    assert sass.issue_ms(counts, 1e9, 132, 1000.0) == pytest.approx(
        80e9 / (128 * 132e9) * 1e3
    )
    counts["xu"] = 40.0
    assert sass.bound_ms(counts, 1e9, 132, 1000.0)[1] == "xu"
    # 128 warps work on 128 of 528 schedulers, each with a quarter of its
    # SM's pipes: 4 MUFU lanes, so a warp's MUFU instruction takes 8
    # clocks and 40 of them per step 320.
    ms, pipe = sass.bound_ms(counts, 4096 * 1e4, 132, 1000.0, warps=128)
    assert pipe == "xu" and ms == pytest.approx(40 * 8 * 1e4 / 1e9 * 1e3)
    assert sass.issue_ms(counts, 4096 * 1e4, 132, 1000.0, warps=128) == (
        pytest.approx(80 * 1e4 / 1e9 * 1e3)
    )
    # 1e4 serial steps of a 50-instruction chain at 4 clocks each.
    assert sass.latency_ms(50, 10_000, 1000.0) == pytest.approx(2.0)


def test_sass_chain_follows_registers_not_order():
    sass = _chip_smoke()

    body = [sass.Instr(16 * i, False, op, args) for i, (op, args) in enumerate([
        ("IMAD", "R2, R0, 0x3, R1"),          # 1
        ("IADD3", "R3, R0, 0x1, RZ"),         # 1: reads R0, not R2
        ("MUFU.LG2", "R4, R2"),               # 2
        ("STS", "[R3], R4"),                  # 3: a store writes no register
        ("FSETP.GE.AND", "P0, PT, R4, 1, PT"),  # 3
        ("FSEL", "R5, R4, RZ, P0"),           # 4
        ("MOV", "R2, RZ"),                    # 1: R2 written again
        ("FADD", "R6, R2, R3"),               # 2
        ("SHFL.DOWN", "PT, R7, R6, 0x10, 0x1f"),  # 3: PT is no destination
        ("FADD", "R8, R7, R7"),               # 4
    ])]
    assert sass.chain_depth(body) == 4
    assert sass.chain_depth(body[6:]) == 4
    assert sass.chain_depth([]) == 0


def _body(sass, rows):
    """Instructions from (opcode, operands[, guard]) rows, 16 bytes apart."""
    return [sass.Instr(16 * i, bool(g), op, args, g[0] if g else "")
            for i, (op, args, *g) in enumerate(rows)]


def test_sass_carried_chain_leaves_out_iteration_local_work():
    sass = _chip_smoke()

    # A counter R0 feeds a 7-instruction hash and log; only the sum R20
    # carries, one FADD per iteration.
    body = _body(sass, [
        ("IADD3", "R0, R0, 0x1, RZ"),
        ("IMAD", "R2, R0, 0x3, R1"),
        ("LOP3.LUT", "R3, R2, 0x55, RZ, 0x3c, !PT"),
        ("SHF.R.U32.HI", "R4, RZ, 0x5, R3"),
        ("IMAD", "R5, R4, 0x9, RZ"),
        ("I2FP.F32.U32", "R6, R5"),
        ("MUFU.LG2", "R7, R6"),
        ("FMUL", "R8, R7, 0.5"),
        ("FADD", "R20, R20, R8"),
        ("ISETP.GE.AND", "P0, PT, R0, R9, PT"),
    ])
    assert sass.chain_depth(body) == 9
    assert sass.carried_depth(body) == 1
    # Without the sum nothing carries but the counter.
    assert sass.carried_depth(body[:8] + body[9:]) == 0
    # A counter that is hashed into its own next value is no counter.
    rehash = _body(sass, [("IMAD", "R2, R0, 0x3, R1"),
                          ("LOP3.LUT", "R0, R2, 0x55, RZ, 0x3c, !PT")])
    assert sass.carried_depth(rehash) == 2


def test_sass_carried_chain_follows_the_recurrence():
    sass = _chip_smoke()

    # An independence step: la = ((lp' + logq) - logp) - lq', the compare,
    # the selects of logp (R10), logq (R11) and x (R12, a guarded MOV);
    # then the sum of x * x (R13), which no later decision reads.
    body = _body(sass, [
        ("IADD3", "R0, R0, 0x1, RZ"),
        ("IMAD", "R2, R0, 0x3, R1"),
        ("MUFU.LG2", "R3, R2"),
        ("FADD", "R4, R3, R11"),
        ("FADD", "R5, R4, -R10"),
        ("FADD", "R6, R5, -R3"),
        ("FSETP.GT.AND", "P1, PT, R6, R2, PT"),
        ("FSEL", "R10, R3, R10, P1"),
        ("FSEL", "R11, R3, R11, P1"),
        ("MOV", "R12, R3", "P1"),
        ("FMUL", "R14, R12, R12"),
        ("FADD", "R15, R14, -R16"),
        ("FADD", "R13, R13, R15"),
    ])
    assert sass.chain_depth(body) == 8
    assert sass.carried_depth(body) == 5
    # The guard is a source: without it the MOV of x would be ready.
    assert body[9].guard == "P1"
    # Two registers that feed each other: 4 instructions from R10 to R11,
    # 5 from R11 to R10, a cycle of 9 over two iterations.
    pair = _body(sass, [
        ("FADD", "R1, R10, 1"), ("FMUL", "R2, R1, R1"), ("FADD", "R20, R2, 3"),
        ("FADD", "R3, R11, 1"), ("FMUL", "R4, R3, R3"), ("FMUL", "R5, R4, R4"),
        ("FMUL", "R6, R5, R4"), ("FADD", "R10, R6, 2"), ("MOV", "R11, R20"),
    ])
    assert sass.carried_depth(pair) == 4.5


def test_sass_parse_keeps_the_guard_and_lanes_divide_the_carried_chain():
    sass = _chip_smoke()

    listing = """
\t\tFunction : _ZN12_GLOBAL__N_111mcmc_kernelEjPKfiiiS1_PfS2_
        /*0000*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0010*/                   I2FP.F32.U32 R2, R0 ;
        /*0020*/                   I2FP.F32.U32 R3, R0 ;
        /*0030*/                   FADD R4, R2, R11 ;
        /*0040*/                   FADD R5, R4, -R10 ;
        /*0050*/                   FSETP.GT.AND P1, PT, R5, R3, PT ;
        /*0060*/              @!P1 MOV R10, R2 ;
        /*0070*/                   FADD R6, R3, R10 ;
        /*0080*/                   FADD R7, R6, -R10 ;
        /*0090*/                   FSETP.GT.AND P2, PT, R7, R2, PT ;
        /*00a0*/               @P2 MOV R10, R3 ;
        /*00b0*/                   ISETP.NE.AND P3, PT, R0, 0x80, PT ;
        /*00c0*/               @P3 BRA 0x0 ;
        /*00d0*/                   EXIT ;
"""
    instrs = sass.parse_functions(listing)[
        "_ZN12_GLOBAL__N_111mcmc_kernelEjPKfiiiS1_PfS2_"]
    assert instrs[6].guard == "P1" and instrs[6].predicated
    # Two steps of one chain per iteration: R10 -> FADD -> FSETP -> MOV,
    # then FADD -> FADD -> FSETP -> MOV.
    (loop,) = sass.loop_counts(instrs)
    assert loop.counts["carried"] == 7
    # Two uniforms per step on each of 4 lanes: the iteration's 2
    # conversions are 1 step per lane, 4 steps of the chain in sequence.
    most, least = sass.per_sample(listing, "mcmc_kernel", 2, lanes=4)
    assert most == least
    assert most["carried"] == 7 / 4
    assert most["chain"] == loop.counts["chain"] / 4
    assert most["issue"] == 13 and most["fma"] == 6


def test_function_warps_are_the_whole_card_only_for_independence():
    sass = _chip_smoke()

    assert sass.function_warps(0, 4096) is None
    assert sass.function_warps(1, 4096) == 128
    assert sass.function_warps(2, 4096, rungs=4) == 512
