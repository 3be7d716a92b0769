"""The extended families (lognormal, Cauchy, Laplace, logistic, Gumbel,
Weibull, Pareto) through the port's five kernels' plain versions, against
the JAX package's interpret-mode Pallas kernels on the same inputs.

* 1-D integrate (``build_integrate_fn_pallas(..., interpret=True)`` at
  256-row blocks): each family in ``mc``, ``antithetic``, ``qmc`` and with
  error bars.  The two draw the same samples (Cauchy's bit for bit, the
  others' within a few ulp, ``tests/test_torch_families.py``), so means
  agree to float32 summation order: within 1e-5 relative plus 1e-5 of the
  column's size (its mean |value| on the pilot grid; a Cauchy x * x column
  is 1e6 and more), error bars within 1e-3 relative plus 1e-9 absolute
  (``tests/test_torch_integrate_variants.py``).
* Importance sampling with family densities (traced) and a table target
  under a Laplace proposal, through both packages' public calls
  (``MonteCarloIntegrator(backend="pallas")`` on the CPU), to the same
  tolerances.
* nd integrate with family dimensions in any mix with U, N and Exp
  (``build_integrate_nd_pallas(..., interpret=True)``), to
  ``tests/test_torch_nd.py``'s tolerances.
* MCMC, nd MCMC and tempered MCMC with family targets and proposals,
  through both packages' public calls, chain for chain as
  ``tests/test_torch_mcmc_custom.py`` holds them: at most 1 % of the
  chains split (final states more than 1e-4 relative apart), means within
  1e-5 of the column's size, acceptance within 1e-4, error bars within
  rel 1e-3.  The tempered runs flush subnormals as XLA's CPU backend does
  (``tests/test_torch_tempering.py``).

The CUDA kernels are held against these plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo.ops.integrate_nd_pallas import (
    build_integrate_nd_pallas,
    pick_nd_rows,
)
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of
from tpu_montecarlo.tracing import trace_function as j_trace
from tpu_montecarlo.utils.dispatch import make_integrate_plan as j_plan

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import mcmc as api_mcmc
from tpu_montecarlo_torch.api import mcmc_nd as api_nd
from tpu_montecarlo_torch.api import tempering as api_pt
from tpu_montecarlo_torch.ops.integrate_kernel import (
    IntegrateProgram,
    library_route,
    pilot_values,
    plan_grid,
)
from tpu_montecarlo_torch.ops.integrate_nd_kernel import (
    IntegrateNdProgram,
    NdConfig,
    finish_stderr,
    integrate_nd_reference,
    pilot_row,
)
from tpu_montecarlo_torch.ops.mcmc_kernel import mcmc_cuda
from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda
from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda
from tpu_montecarlo_torch.sampling import DistKind
from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

from test_torch_integrate_variants import jax_run, port_run

FAMILIES = {
    "lognormal": (0.0, 0.5),
    "cauchy": (0.0, 1.0),
    "laplace": (3.0, 1.0),
    "logistic": (0.0, 2.0),
    "gumbel": (1.0, 0.5),
    "weibull": (1.5, 2.0),
    "pareto": (1.0, 3.0),
}
FNS = [lambda x: x, lambda x: x * x, lambda x: np.exp(-x * x), lambda x: x > 1.0]
N_SMALL = 1 << 16
MEAN_RTOL = MEAN_ATOL = 1e-5
STDERR_RTOL, STDERR_ATOL = 1e-3, 1e-9
MODES = {
    "mc": ("mc", False),
    "antithetic": ("antithetic", False),
    "qmc": ("qmc", False),
    "mc-stderr": ("mc", True),
    "antithetic-stderr": ("antithetic", True),
}
THREADS = 1024
CPU_CHUNK = 1 << 22


def _dist(pkg, name):
    return getattr(pkg.Distribution, name)(*FAMILIES[name])


def _size(program, kind, params):
    """Each column's size: its mean |value| over the pilot grid."""
    return pilot_values(lambda *a: [v.abs() for v in program.torch_values(*a)],
                        kind, torch.tensor(params)).double().numpy()


def _means_close(got, want, size):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    size = np.maximum(size, np.abs(want))
    assert np.all(np.isfinite(got))
    err = np.abs(got - want)
    assert np.all(err <= MEAN_RTOL * np.abs(want) + MEAN_ATOL * size), (got, want)


def _runs_close(got, want, with_stderr, size):
    if not with_stderr:
        _means_close(got, want, size)
        return
    _means_close(got[0], want[0], size)
    se, want_se = np.asarray(got[1], np.float64), np.asarray(want[1], np.float64)
    tol = STDERR_RTOL * np.abs(want_se) + STDERR_ATOL * np.maximum(size, 1.0)
    assert np.all(np.abs(se - want_se) <= tol), (se, want_se)


# -- 1-D integrate ------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_plain_1d_matches_jax_interpret_kernel(name, mode):
    method, with_stderr = MODES[mode]
    spec = j_dist_spec_of(_dist(jmc, name))
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in FNS))
    want, actual = jax_run(tuple(j_trace(f) for f in FNS), spec.kind,
                           spec.params, N_SMALL, method, with_stderr, 42)
    got, grid = port_run(program, spec.kind, spec.params, N_SMALL, method,
                         with_stderr, 42)
    assert grid.actual_samples == actual
    _runs_close(got, want, with_stderr, _size(program, spec.kind, spec.params))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_pilot_is_the_family_quantile_grid(name):
    # The JAX kernel's _pilot_vals: f over inv_cdf((i + 0.5) / 1024).
    dist = _dist(tm, name)
    kind = DistKind[name.upper()]
    u = (np.arange(1024) + 0.5) / 1024
    x = np.array([dist.quantile(float(v)) for v in u])
    if name in ("weibull", "pareto"):  # their samplers draw from 1 - u
        x = x[::-1]
    program = IntegrateProgram(tuple(tm.trace_function(f) for f in FNS))
    got = pilot_values(program.torch_values, kind,
                       torch.tensor(tm.sampling.dist_spec_of(dist).params))
    want = [x.mean(), (x * x).mean(), np.exp(-x * x).mean(), (x > 1.0).mean()]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)


def test_family_libraries_are_their_own():
    # An extended family compiles into a library of its own; the uniform,
    # normal and exponential families keep theirs, and CUSTOM its route.
    assert library_route(DistKind.NORMAL) is None
    assert library_route(DistKind.CAUCHY) == DistKind.CAUCHY
    with pytest.raises(ValueError, match="not a CUSTOM route or an extended"):
        IntegrateProgram((tm.trace_function(lambda x: x),)).library(
            route=DistKind.CUSTOM)


# -- importance sampling ----------------------------------------------------------------


def _bimodal(x):
    return 0.5 * np.exp(-0.5 * (x + 2.0) ** 2) + 0.5 * np.exp(-0.5 * (x - 2.0) ** 2)


# name: (functions, target, proposal, keywords)
IS_CASES = {
    "laplace-target-logistic-proposal": (
        [lambda x: x, lambda x: x * x], lambda p: p.Distribution.laplace(3.0, 1.0),
        lambda p: p.Distribution.logistic(2.5, 2.0), dict(return_stderr=True)),
    "normal-target-cauchy-proposal": (
        [lambda x: x * x, lambda x: x > 1.5], lambda p: p.Distribution.normal(0.0, 1.0),
        lambda p: p.Distribution.cauchy(0.0, 1.5),
        dict(method="antithetic", return_stderr=True)),
    "gumbel-target-lognormal-proposal": (
        [lambda x: x], lambda p: p.Distribution.gumbel(1.0, 0.5),
        lambda p: p.Distribution.lognormal(0.3, 0.6), dict(method="qmc")),
    "weibull-target-pareto-proposal": (
        [lambda x: x, lambda x: x > 2.0], lambda p: p.Distribution.weibull(1.5, 2.0),
        lambda p: p.Distribution.pareto(0.5, 1.5),
        dict(return_stderr=True, return_diagnostics=True)),
    "table-target-laplace-proposal": (
        [lambda x: x * x], lambda p: p.Distribution.from_pdf(_bimodal, support=(-6.0, 6.0)),
        lambda p: p.Distribution.laplace(0.0, 2.0), dict(return_stderr=True)),
}


@pytest.mark.parametrize("case", list(IS_CASES))
def test_importance_sampling_matches_jax_pallas_backend(case):
    fns, target, proposal, kw = IS_CASES[case]
    kw = dict(n_samples=N_SMALL, seed=7, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the JAX kernel, not its XLA sweep
        want = jmc.MonteCarloIntegrator(backend="pallas").integrate_importance_sampling(
            fns, target(jmc), proposal(jmc), **kw)
    got = tm.MonteCarloIntegrator(device="cpu").integrate_importance_sampling(
        fns, target(tm), proposal(tm), **kw)
    assert got.values.shape == (len(fns),) and got.n_samples == N_SMALL
    size = np.maximum(np.abs(np.asarray(want.values)), 1.0)
    _means_close(got.values, want.values, size)
    if kw.get("return_stderr"):
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)
    if kw.get("return_diagnostics"):
        for key in ("ess", "mean_weight", "weight_cv"):
            np.testing.assert_allclose(got.diagnostics[key],
                                       want.diagnostics[key], rtol=1e-4)


# -- nd integrate --------------------------------------------------------------------

FOUR = ["lognormal", "cauchy", "laplace", "logistic"]
THREE = ["gumbel", "weibull", "pareto"]
ND_CASES = {
    # Every family as a dimension, four and three at a time (wider tuples
    # shrink the JAX kernel's tiles below 256 rows, pick_nd_rows).
    "four-mc": ([lambda a, b, c, d: a + c + d, lambda a, b, c, d: (b > 1.0) * a],
                FOUR, "mc", False),
    "four-antithetic": ([lambda a, b, c, d: a * d + c, lambda a, b, c, d: np.exp(-b * b)],
                        FOUR, "antithetic", False),
    "four-qmc": ([lambda a, b, c, d: a + np.exp(-b * b) + c + d], FOUR, "qmc", False),
    "three-mc-stderr": ([lambda a, b, c: a * b + c, lambda a, b, c: c > 1.5],
                        THREE, "mc", True),
    "three-qmc": ([lambda a, b, c: a + b * c], THREE, "qmc", False),
    # Families beside U, N and Exp, with error bars.
    "mixed-mc-stderr": ([lambda x, y, z, w: x * y + z - w, lambda x, y, z, w: x * x + w],
                        ["lognormal", ("normal", 0.5, 1.5), "gumbel", ("exponential", 2.0)],
                        "mc", True),
    "mixed-antithetic-stderr": ([lambda x, y, z: x + y * z],
                                [("uniform", -1.0, 2.0), "laplace", "weibull"],
                                "antithetic", True),
    "c9-cells-qmc": ([lambda x, y: np.exp(-x) * y, lambda x, y: x * y],
                     ["lognormal", "gumbel"], "qmc", False),
}


def _nd_dists(pkg, dims):
    out = []
    for dim in dims:
        if isinstance(dim, str):
            out.append(_dist(pkg, dim))
        else:
            out.append(getattr(pkg.Distribution, dim[0])(*dim[1:]))
    return out


@pytest.mark.parametrize("case", list(ND_CASES))
def test_plain_nd_matches_jax_interpret_kernel(case):
    fns, dims, method, with_stderr = ND_CASES[case]
    specs = [j_dist_spec_of(d) for d in _nd_dists(jmc, dims)]
    kinds = tuple(int(s.kind) for s in specs)
    params = np.stack([s.params for s in specs])
    d, k, n = len(kinds), len(fns), 1 << 18
    plan = j_plan(n, THREADS, max_chunk_elems=CPU_CHUNK)
    grid_samples = (-(-plan.actual_samples // 2) if method == "antithetic"
                    else plan.actual_samples)
    assert pick_nd_rows(k, d, grid_samples, with_stderr=with_stderr,
                        kinds=kinds, method=method) == 256
    run = build_integrate_nd_pallas(tuple(j_trace(f, d) for f in fns), kinds,
                                    plan, interpret=True, method=method,
                                    with_stderr=with_stderr)
    program = IntegrateNdProgram(tuple(tm.trace_function(f, d) for f in fns),
                                 kinds)
    cfg = NdConfig(kinds, method, with_stderr)
    grid = plan_grid(make_integrate_plan(n, THREADS).actual_samples, method)
    assert grid.actual_samples == run.actual_samples
    p = torch.tensor(params)
    want = run(np.int32(42), params)
    nf = float(np.float32(grid.actual_samples))
    size = np.maximum(np.abs(pilot_row(
        [lambda *xs, f=f: f(*xs).abs() for f in program.torch_fns], kinds,
        p).double().numpy()), 1e-3)
    if not with_stderr:
        got = integrate_nd_reference(program.torch_fns, cfg, p, 42, grid) / nf
        _means_close(got.numpy(), want, size)
        return
    pilot = pilot_row(program.torch_fns, kinds, p)
    sums, sqs = integrate_nd_reference(program.torch_fns, cfg, p, 42, grid,
                                       pilot)
    mean, se = finish_stderr(sums, sqs, pilot, grid, cfg.antithetic)
    _means_close(mean.numpy(), want[0], size)
    np.testing.assert_allclose(se.numpy(), want[1], rtol=1e-4, atol=0.0)


def test_nd_public_path_takes_family_dimensions():
    r = tm.integrate([lambda x, y: x * y, lambda x, y: x + y],
                     [tm.Distribution.laplace(3.0, 1.0),
                      tm.Distribution.logistic(0.0, 2.0)],
                     n_samples=1 << 20, return_stderr=True, device="cpu")
    assert np.all(np.abs(r.values - [0.0, 3.0]) < 6 * r.stderr)


# -- MCMC ----------------------------------------------------------------------------

N_CHAINS, N_STEPS, N_BURNIN = 1024, 40, 10
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.01
ACCEPT_ATOL = 1e-4


def _make(pkg, spec):
    if isinstance(spec, dict):
        return pkg.RandomWalk(**spec)
    if callable(spec):
        return spec
    if isinstance(spec, list):
        return [_make(pkg, s) for s in spec]
    if isinstance(spec, str):
        return _dist(pkg, spec)
    return getattr(pkg.Distribution, spec[0])(*spec[1:])


def _joint(x, y):
    return -0.5 * (x * x + y * y) - 0.5 * x * y


@contextlib.contextmanager
def _flushing_subnormals():
    """Flush float32 subnormals, as XLA's CPU backend does, on one torch
    thread (``tests/test_torch_tempering.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


# name: (functions, target, proposal, temperatures, with_stderr)
MCMC_CASES = {
    # 1-D: c5b's family cell scaled down, and each family as a target.
    "laplace-target-logistic-proposal": (
        [lambda x: x, lambda x: x * x], "laplace", ("logistic", 0.0, 2.0), None, True),
    "cauchy-target-walk": (
        [lambda x: x > 1.0, lambda x: np.exp(-x * x)], "cauchy",
        dict(step_size=2.0), None, False),
    "gumbel-target-lognormal-proposal": (
        [lambda x: x], "gumbel", ("lognormal", 0.3, 0.8), None, False),
    "weibull-target-adaptive-walk": (
        [lambda x: x, lambda x: x * x], "weibull", dict(adapt=True), None, True),
    "pareto-target-weibull-proposal": (
        [lambda x: x > 1.5], "pareto", ("weibull", 1.2, 1.5), None, False),
    "lognormal-target-gumbel-proposal": (
        [lambda x: x], "lognormal", ("gumbel", 1.0, 0.6), None, False),
    # No error bars: the pilot, a mean over the Cauchy proposal's first
    # draws (x * x up to 1e13), leaves both packages' float32 chain sums at
    # their rounding.
    "normal-target-cauchy-proposal": (
        [lambda x: x * x], ("normal", 0.0, 1.0), ("cauchy", 0.0, 1.5), None, False),
    "logistic-target-laplace-proposal": (
        [lambda x: x * x], "logistic", ("laplace", 0.0, 2.5), None, False),
    # nd: product targets and proposals of families, a joint target.
    "nd-family-product": (
        [lambda x, y: x * y, lambda x, y: x + y], ["laplace", "gumbel"],
        [("logistic", 3.0, 1.5), ("lognormal", 0.0, 0.6)], None, True),
    "nd-family-walk": (
        [lambda x, y, z: x + y + z], ["weibull", ("normal", 0.0, 1.0), "cauchy"],
        dict(step_size=[1.0, 1.0, 2.0], adapt=True), None, False),
    "nd-joint-cauchy-proposals": (
        [lambda x, y: x * y], _joint, [("cauchy", 0.0, 1.5), ("laplace", 0.0, 1.5)],
        None, True),
    # Tempered: family target dimensions and proposal dimensions.
    "tempered-family-target-walk": (
        [lambda x: x, lambda x: x * x], "gumbel",
        dict(step_size=0.5, adapt=True, init_range=(0.0, 2.0)), [1.0, 2.0, 4.0], True),
    "tempered-family-proposals": (
        [lambda x, y: x + y], ["laplace", ("normal", 0.0, 1.0)],
        [("cauchy", 3.0, 1.0), ("logistic", 0.0, 1.0)], [1.0, 2.5], False),
    "tempered-joint-family-proposal": (
        [lambda x, y: x * y], _joint, [("laplace", 0.0, 1.5), ("gumbel", 0.0, 1.5)],
        [1.0, 2.0, 3.0], False),
}


def _jax_mcmc(case):
    fns, target, proposal, temps, stderr = MCMC_CASES[case]
    extra = {} if temps is None else {"temperatures": temps}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the JAX kernel, not its XLA sweep
        r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            fns, _make(jmc, target), _make(jmc, proposal), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42, return_stderr=stderr,
            return_samples=N_STEPS, **extra)
    return r, np.asarray(r.samples[-1]).reshape(N_CHAINS, -1)


def _port_mcmc(case, monkeypatch):
    fns, target, proposal, temps, stderr = MCMC_CASES[case]
    outs = []
    for module, name, wrapper in ((api_mcmc, "mcmc_cuda", mcmc_cuda),
                                  (api_nd, "mcmc_nd_cuda", mcmc_nd_cuda),
                                  (api_pt, "mcmc_pt_cuda", mcmc_pt_cuda)):
        def spy(*args, wrapper=wrapper):
            outs.append(wrapper(*args))
            return outs[-1]

        monkeypatch.setattr(module, name, spy)
    extra = {} if temps is None else {"temperatures": temps}
    with _flushing_subnormals() if temps else contextlib.nullcontext():
        r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            fns, _make(tm, target), _make(tm, proposal), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=42, return_stderr=stderr,
            **extra)
    assert len(outs) == 1
    x = outs[0].x_final.numpy()
    return r, (x.reshape(-1, 1) if x.ndim == 1 else x.T)


@pytest.mark.parametrize("case", list(MCMC_CASES))
def test_mcmc_plain_versions_match_jax_kernels(case, monkeypatch):
    want, x_jax = _jax_mcmc(case)
    got, x_port = _port_mcmc(case, monkeypatch)
    assert x_port.shape[0] >= N_CHAINS
    x_port = x_port[:N_CHAINS]
    split = (np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))).any(axis=1)
    assert split.mean() <= MAX_SPLIT, f"{split.mean():.2%} of the chains split"
    size = np.maximum(np.abs(np.asarray(want.values)), 1.0)
    _means_close(got.values, want.values, size)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= ACCEPT_ATOL
    if MCMC_CASES[case][4]:
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)
    if MCMC_CASES[case][3] is not None:
        np.testing.assert_allclose(got.diagnostics["swap_rate"],
                                   want.diagnostics["swap_rate"], atol=1e-3)


def test_reference_mcmc_tolerances_on_families():
    # tests/test_families.py TestMcmc, on the port: a Laplace target and a
    # logistic proposal, within 0.2 and 0.1.
    integ = tm.MonteCarloIntegrator(device="cpu")
    r = integ.integrate_mcmc([lambda x: x], tm.Distribution.laplace(3.0, 1.0),
                             tm.Distribution.normal(0.0, 2.0), n_steps=3000,
                             n_chains=512, n_burnin=500)
    assert abs(r.values[0] - 3.0) < 0.2 and 0.05 < r.acceptance_rate < 0.95
    r = integ.integrate_mcmc([lambda x: x * x], tm.Distribution.normal(0.0, 1.0),
                             tm.Distribution.logistic(0.0, 2.0), n_steps=3000,
                             n_chains=512, n_burnin=500)
    assert abs(r.values[0] - 1.0) < 0.1
