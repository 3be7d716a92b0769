"""The port's 1-D ``integrate`` modes against the JAX package: antithetic,
QMC (the rotated radical inverse, with its segments past 2**32 points),
error bars under mc and antithetic, and randomized QMC.

The port's plain PyTorch version draws, tile for tile, the samples of the
JAX kernel ``build_integrate_fn_pallas`` in interpret mode at 256-row
blocks (``block_rows=256``, which the port always keeps).  So:

* QMC uniforms are bit-equal to the JAX package's ``qmc_u01_*``;
* uniform and exponential samples agree within 4 ulp, normal ones within
  4 ulp of z plus one uniform step through the quantile, times the std
  (torch's and XLA's ``erfinv`` differ in their last bits; the
  tolerance of ``tests/test_torch_nd.py``);
* means within 1e-5 absolute plus 1e-5 relative (float32 summation order,
  and one indicator sample that the two erfinvs may put on either side of
  its edge);
* error bars within 1e-3 relative: the same squares up to summation order
  and the pilot, a mean over a 1,024-point grid; plus 1e-9 absolute,
  for an odd integrand whose antithetic pairs cancel exactly (x under a
  symmetric family), whose error bar is float32 rounding of the pair
  means on both sides (~1e-11, against ~1e-4 for the others).

Sizes stay at or below 2**18 samples.  The CUDA kernel is held against the
plain version in ``test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.ops import qmc as jqmc
from tpu_montecarlo.ops.integrate_pallas import (
    CounterRng as JCounterRng,
    _sample_subblocks_antithetic,
    _sample_subblocks_qmc,
    build_integrate_fn_pallas,
)
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops import integrate_kernel as ik
from tpu_montecarlo_torch.ops import qmc
from tpu_montecarlo_torch.ops.integrate_kernel import (
    IntegrateConfig,
    IntegrateProgram,
    finish_stderr,
    integrate_cuda,
    integrate_reference,
    pilot_values,
    plan_grid,
    qmc_seg_bits,
    sample_subblocks_antithetic,
    sample_subblocks_qmc,
)
from tpu_montecarlo_torch.sampling import DistKind
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

THREADS = 1024
CPU_CHUNK = 1 << 22  # the JAX package's max_chunk_elems off the TPU
N_SMALL = 1 << 18
MEAN_ATOL = MEAN_RTOL = 1e-5
STDERR_RTOL = 1e-3
STDERR_ATOL = 1e-9

FAMILIES = {
    "uniform": lambda pkg: pkg.Distribution.uniform(-1.0, 2.0),
    "normal": lambda pkg: pkg.Distribution.normal(0.5, 1.5),
    "exponential": lambda pkg: pkg.Distribution.exponential(2.0),
}
FNS = [lambda x: x, lambda x: x * x, lambda x: np.exp(-x * x), lambda x: x > 1.0]


def _close(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64),
        rtol=rtol, atol=atol,
    )


def _words(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


# -- the radical inverse, bit for bit -----------------------------------------


@pytest.mark.parametrize("open01", [False, True], ids=["halfopen", "open"])
def test_qmc_uniforms_bit_equal(open01):
    idx, shift = _words(1, 8192), _words(2, 8192)
    port = qmc.qmc_u01_open if open01 else qmc.qmc_u01_halfopen
    ref = jqmc.qmc_u01_open if open01 else jqmc.qmc_u01_halfopen
    got = port(torch.from_numpy(idx.astype(np.int64)),
               torch.from_numpy(shift.astype(np.int64)))
    want = np.asarray(ref(jnp.asarray(idx), jnp.asarray(shift)))
    np.testing.assert_array_equal(got.numpy(), want)
    # A scalar rotation broadcasts, and 0 and 2**32 - 1 wrap.
    edge = np.array([0, 1, 0xFFFFFFFF, 0x80000000], np.uint32)
    for s in (0, 0xFFFFFFFF, int(shift[0])):
        got = port(torch.from_numpy(edge.astype(np.int64)), s)
        want = np.asarray(ref(jnp.asarray(edge), jnp.uint32(s)))
        np.testing.assert_array_equal(got.numpy(), want)


# -- the plan --------------------------------------------------------------------

PLAN_NS = [1, 1000, 32_768, 65_537, 262_145, 1 << 20, 10_000_000,
           100_000_001, (1 << 30) + 1, 3_000_000_000]


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_plan_matches_jax_actual_samples(method):
    fns = (j_trace(lambda x: x),)
    kind = j_dist_spec_of(jmc.Distribution.normal(0.0, 1.0)).kind
    for n in PLAN_NS:
        plan = j_plan(n, None, max_chunk_elems=CPU_CHUNK)
        run = build_integrate_fn_pallas(fns, kind, plan, interpret=True,
                                        method=method, block_rows=256)
        grid = plan_grid(plan.actual_samples, method)
        assert grid.actual_samples == run.actual_samples, n
        assert grid.actual_samples >= n


def test_qmc_segments_only_past_two_to_the_32():
    assert qmc_seg_bits(plan_grid(1 << 31, "qmc")) is None
    # Whole programs of 512 tiles: 255 stay below 2**32 points, 256 reach it.
    assert qmc_seg_bits(plan_grid(255 * 512 * 32_768, "qmc")) is None
    assert qmc_seg_bits(plan_grid(255 * 512 * 32_768 + 1, "qmc")) == 17
    with pytest.raises(ValueError, match="exceeds int32"):
        qmc_seg_bits(plan_grid(1 << 46, "qmc"))


# -- one tile's draws against the JAX kernel's ---------------------------------


def _samples_close(kind, mean, std, got, want):
    """Uniform and exponential samples within 4 ulp; normal ones within
    4 ulp of z plus one uniform step through the quantile, times the std,
    plus 2 ulp for the affine map (module docstring)."""
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


def _spec(name):
    spec = j_dist_spec_of(FAMILIES[name](jmc))
    return spec.kind, float(spec.params[0]), float(spec.params[1])


@pytest.mark.parametrize("segmented", [False, True], ids=["one-segment", "segments"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tile_qmc_samples_match_jax(family, segmented):
    kind, p1, p2 = _spec(family)
    seed = (1 << 31) + 77
    shift0 = jqmc.derive_shift(jnp.asarray(seed, jnp.uint32), 1)
    blocks = [0, 7, (1 << 17) + 3, 3 * (1 << 17) + 11] if segmented else [0, 7, 511]
    for b in blocks:
        bb, shift = b, shift0
        if segmented:
            bb, shift = b & ((1 << 17) - 1), jqmc.derive_segment_shift(shift0, b >> 17)
        want = _sample_subblocks_qmc(kind, jnp.float32(p1), jnp.float32(p2),
                                     jnp.int32(bb), shift)
        got = sample_subblocks_qmc(
            kind, torch.tensor(p1), torch.tensor(p2), torch.tensor([bb]),
            torch.tensor([int(shift)]),
        )
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _samples_close(kind, p1, p2, g[0].numpy(), w)
    # The port's tile walk gives the same blocks and rotations.
    grid = plan_grid((1 << 33) if segmented else (1 << 24), "qmc")
    tiles = torch.tensor(blocks)
    walked = ik.tile_subblocks(IntegrateConfig("qmc"), kind, torch.tensor(p1),
                               torch.tensor(p2), seed, grid, tiles)
    for i, b in enumerate(blocks):
        bb, shift = b, qmc.derive_shift(seed, 1)
        if segmented:
            bb, shift = b & ((1 << 17) - 1), qmc.derive_segment_shift(shift, b >> 17)
        direct = sample_subblocks_qmc(kind, torch.tensor(p1), torch.tensor(p2),
                                      torch.tensor([bb]), shift.reshape(1))
        for w, d in zip(walked, direct):
            assert torch.equal(w[i], d[0])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tile_antithetic_samples_match_jax(family):
    kind, p1, p2 = _spec(family)
    seed, pid, blk = (1 << 31) + 9, 3, 5
    rng = JCounterRng()
    rng.seed(jnp.asarray(seed, jnp.uint32).astype(jnp.int32), pid)
    want = _sample_subblocks_antithetic(kind, jnp.float32(p1), jnp.float32(p2),
                                        rng, blk)
    got = sample_subblocks_antithetic(kind, torch.tensor(p1), torch.tensor(p2),
                                      ik.CounterRng(seed, pid), blk)
    assert len(got) == len(want) == (4 if kind == DistKind.NORMAL else 2)
    for g, w in zip(got, want):
        _samples_close(kind, p1, p2, g.numpy(), w)


# -- the plain version against the interpret-mode JAX kernel --------------------

MODES = {
    "antithetic": ("antithetic", False),
    "qmc": ("qmc", False),
    "mc-stderr": ("mc", True),
    "antithetic-stderr": ("antithetic", True),
}


def jax_run(fns, kind, params, n, method, with_stderr, seed):
    """The interpret-mode JAX kernel at 256-row blocks: (means[, stderrs])
    and its actual sample count."""
    plan = j_plan(n, THREADS, max_chunk_elems=CPU_CHUNK)
    run = build_integrate_fn_pallas(fns, kind, plan, interpret=True,
                                    method=method, with_stderr=with_stderr,
                                    block_rows=256)
    dummy = np.zeros(1, np.float32)
    out = run(np.asarray(seed, np.uint32), params, dummy, dummy)
    if with_stderr:
        return (np.asarray(out[0]), np.asarray(out[1])), run.actual_samples
    return np.asarray(out), run.actual_samples


def port_run(program, kind, params, n, method, with_stderr, seed):
    """The port's plain version on the same plan: (means[, stderrs])."""
    cfg = IntegrateConfig(method, with_stderr)
    grid = plan_grid(make_integrate_plan(n, THREADS).actual_samples, method)
    p = torch.tensor(params)
    if not with_stderr:
        sums = integrate_cuda(program, kind, p, seed, grid, cfg)
        return (sums / float(np.float32(grid.actual_samples))).numpy(), grid
    pilot = pilot_values(program.torch_values, kind, p)
    sums, sqs = integrate_cuda(program, kind, p, seed, grid, cfg, pilot)
    mean, se = finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
    return (mean.numpy(), se.numpy()), grid


def assert_runs_agree(got, want, with_stderr):
    if with_stderr:
        _close(got[0], want[0])
        _close(got[1], want[1], rtol=STDERR_RTOL, atol=STDERR_ATOL)
        assert np.all(got[1] > 0)
    else:
        assert got.dtype == np.float32
        _close(got, want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_plain_version_matches_jax_interpret_kernel(family, mode):
    method, with_stderr = MODES[mode]
    spec = j_dist_spec_of(FAMILIES[family](jmc))
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in FNS))
    jfns = tuple(j_trace(f) for f in FNS)
    for seed in (42, (1 << 31) + 3):
        want, actual = jax_run(jfns, spec.kind, spec.params, N_SMALL, method,
                               with_stderr, seed)
        got, grid = port_run(program, spec.kind, spec.params, N_SMALL, method,
                             with_stderr, seed)
        assert grid.actual_samples == actual
        assert_runs_agree(got, want, with_stderr)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_qmc_segments_match_jax_interpret_kernel(family, monkeypatch):
    # A 2**17-point segment (4 tiles) on both sides: the run crosses
    # segments 8 times, each under its own rotation.
    monkeypatch.setattr(jqmc, "QMC_MAX_SAMPLES", 1 << 17)
    monkeypatch.setattr(ik, "QMC_MAX_SAMPLES", 1 << 17)
    monkeypatch.setattr(ik, "SEG_BITS", 2)
    spec = j_dist_spec_of(FAMILIES[family](jmc))
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in FNS))
    want, actual = jax_run(tuple(j_trace(f) for f in FNS), spec.kind,
                           spec.params, N_SMALL, "qmc", False, 42)
    got, grid = port_run(program, spec.kind, spec.params, N_SMALL, "qmc",
                         False, 42)
    assert qmc_seg_bits(grid) == 2 and grid.actual_samples == actual
    assert_runs_agree(got, want, False)
    # And the segments change the result: each has its own rotation.
    monkeypatch.setattr(ik, "QMC_MAX_SAMPLES", 1 << 32)
    one, _ = port_run(program, spec.kind, spec.params, N_SMALL, "qmc", False, 42)
    assert not np.array_equal(one, got)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pilot_is_the_midpoint_grid(family):
    # The JAX kernel's _pilot_vals: f over x(u) at u = (i + 0.5) / 1024.
    spec = j_dist_spec_of(FAMILIES[family](jmc))
    p1, p2 = (np.float32(v) for v in spec.params)
    u = (np.arange(1024, dtype=np.float32) + np.float32(0.5)) / np.float32(1024)
    if spec.kind == DistKind.UNIFORM:
        x = p1 + u * (p2 - p1)
    elif spec.kind == DistKind.NORMAL:
        x = p1 + p2 * np.asarray(jmc.sampling.normal_from_u01(jnp.asarray(u)))
    else:
        x = -np.log(np.maximum(u, np.float32(1e-7))) / p1
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in FNS))
    got = pilot_values(program.torch_values, spec.kind, torch.tensor(spec.params))
    want = [np.mean(x), np.mean(x * x), np.mean(np.exp(-x * x)),
            np.mean((x > 1.0).astype(np.float32))]
    _close(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert got.dtype == torch.float32


# -- the public path --------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rqmc_matches_jax_rotations(family):
    # Randomized QMC: rotations of ceil(n / r) points at seeds seed +
    # 0x9E3779B9 i; the mean of their means and the spread over sqrt(r).
    n, r, seed = N_SMALL, 4, 11
    spec = j_dist_spec_of(FAMILIES[family](jmc))
    jfns = tuple(j_trace(f) for f in FNS)
    seeds = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(r, dtype=np.uint32)
    vals = np.stack([
        jax_run(jfns, spec.kind, spec.params, -(-n // r), "qmc", False, int(s))[0]
        for s in seeds
    ]).astype(np.float64)
    integ = tm.MonteCarloIntegrator(target_threads=THREADS, device="cpu")
    got = integ.integrate(FNS, FAMILIES[family](tm), n_samples=n, seed=seed,
                          method="qmc", return_stderr=True, qmc_rotations=r)
    assert got.n_samples == n and got.values.dtype == np.float64
    _close(got.values, vals.mean(axis=0))
    spread = vals.std(axis=0, ddof=1) / np.sqrt(r)
    assert np.all(np.abs(got.stderr - spread)
                  <= MEAN_ATOL + MEAN_RTOL * np.abs(vals.mean(axis=0)))


@pytest.mark.parametrize(
    "family,exact", [("uniform", [0.5, 1.0]), ("normal", [0.5, 2.5]),
                     ("exponential", [0.5, 0.5])],
)
@pytest.mark.parametrize("method", ["mc", "antithetic"])
def test_error_bars_cover_the_closed_forms(family, exact, method):
    r = tm.integrate([lambda x: x, lambda x: x * x], FAMILIES[family](tm),
                     n_samples=1 << 20, seed=5, method=method,
                     return_stderr=True, device="cpu")
    assert r.stderr.shape == (2,) and np.all(r.stderr > 0)
    assert np.all(np.abs(r.values - exact) < 6 * r.stderr)


@pytest.mark.parametrize(
    "dist,exact",
    [(lambda: tm.Distribution.normal(3.0, 2.0), 3.0),
     (lambda: tm.Distribution.uniform(-1.0, 3.0), 1.0)],
    ids=["normal", "uniform"],
)
def test_antithetic_cancels_odd_integrands_exactly(dist, exact):
    # Reference tests/test_antithetic.py: x and its mirror average to the
    # mean pair by pair.
    r = tm.integrate([lambda x: x], dist(), n_samples=200_000, seed=42,
                     method="antithetic", return_stderr=True, device="cpu")
    assert abs(r.values[0] - exact) < 1e-5
    assert r.stderr[0] < 1e-6


def test_antithetic_beats_mc_on_a_monotone_integrand():
    kw = dict(n_samples=400_000, seed=1, return_stderr=True, device="cpu")
    f = [lambda x: math.e ** (0.5 * x)]
    d = tm.Distribution.normal(0.0, 1.0)
    rm = tm.integrate(f, d, method="mc", **kw)
    ra = tm.integrate(f, d, method="antithetic", **kw)
    assert abs(ra.values[0] - math.exp(0.125)) < 0.01
    assert ra.stderr[0] < 0.7 * rm.stderr[0]


def test_rqmc_bars_beat_mc_bars_on_a_smooth_integrand():
    # Reference tests/test_stderr.py TestRandomizedQmcStderr.
    d = tm.Distribution.uniform(0.0, 1.0)
    fn = [lambda x: np.exp(x)]
    rq = tm.integrate(fn, d, n_samples=1_000_000, seed=3, method="qmc",
                      return_stderr=True, device="cpu")
    rm = tm.integrate(fn, d, n_samples=1_000_000, seed=3, return_stderr=True,
                      device="cpu")
    assert rq.stderr[0] < 0.2 * rm.stderr[0]
    assert abs(rq.values[0] - (np.e - 1.0)) < 1e-4


def test_qmc_without_error_bars_is_one_rotation():
    d = tm.Distribution.normal(0.0, 1.0)
    r = tm.integrate([lambda x: x * x], d, n_samples=1 << 18, seed=4,
                     method="qmc", device="cpu")
    assert r.stderr is None and abs(r.values[0] - 1.0) < 1e-3


ARG_ERRORS = {
    "method": dict(method="sobol"),
    "rotations": dict(method="qmc", return_stderr=True, qmc_rotations=1),
}


@pytest.mark.parametrize("case", list(ARG_ERRORS))
def test_argument_errors_match_jax(case):
    kw = ARG_ERRORS[case]

    def call(pkg, integ):
        return integ.integrate([lambda x: x], pkg.Distribution.uniform(0.0, 1.0),
                               n_samples=1000, **kw)

    with pytest.raises(ValueError) as want:
        call(jmc, jmc.MonteCarloIntegrator(backend="pallas"))
    with pytest.raises(ValueError) as got:
        call(tm, tm.MonteCarloIntegrator(device="cpu"))
    assert str(got.value) == str(want.value)


def test_config_and_pilot_checks():
    # qmc takes in-kernel squares, as the JAX kernel does.
    assert IntegrateConfig("qmc", with_stderr=True).defines == (
        "#define TMC_METHOD 2\n#define TMC_STDERR 1\n")
    with pytest.raises(ValueError, match="method must be"):
        IntegrateConfig("sobol")
    assert IntegrateConfig().defines == ""
    assert IntegrateConfig("antithetic", True).defines == (
        "#define TMC_METHOD 1\n#define TMC_STDERR 1\n")
    program = IntegrateProgram((tm.trace_function(lambda x: x),))
    params = torch.tensor([0.0, 1.0])
    grid = plan_grid(1 << 16)
    cfg = IntegrateConfig("mc", True)
    with pytest.raises(ValueError, match="pilot"):
        integrate_cuda(program, DistKind.UNIFORM, params, 1, grid, cfg)
    with pytest.raises(ValueError, match="pilot"):
        integrate_cuda(program, DistKind.UNIFORM, params, 1, grid, cfg,
                       torch.zeros(2))
    with pytest.raises(ValueError, match="only for error bars"):
        integrate_cuda(program, DistKind.UNIFORM, params, 1, grid,
                       pilot=torch.zeros(1))
    # On the CPU the wrapper is the plain version, launching nothing.
    before = integrate_cuda.launches
    pilot = torch.zeros(1)
    got = integrate_cuda(program, DistKind.UNIFORM, params, 1, grid, cfg, pilot)
    want = integrate_reference(program.torch_values, DistKind.UNIFORM, params, 1,
                               grid, cfg, pilot)
    assert got.shape == (2, 1) and torch.equal(got, want)
    assert integrate_cuda.launches == before
