"""The JAX package's own CUSTOM-table tests, run against the port.

The cases of ``tests/test_distributions.py`` (table sizes, sanitisation,
Beta moments, the triangular ``from_pdf``), ``tests/test_gapped_pallas.py``
(no sample inside a gap, the bimodal islands, a gapped IS proposal),
``tests/test_mixture.py`` (moments, gap composition, quantile knots),
``tests/test_scipy_families.py`` (moments, heavy-tail routing and mass, IS
proposals) and ``tests/test_importance_sampling.py:184-240`` (densities
that do not trace), as parametrised cases where they repeat each other,
each with the reference's own tolerance, on the port's public API
(``device="cpu"``, the plain version).  Sample counts are the reference's
or smaller (at most 2**20): each tolerance is many standard errors wide at
that count.  Every method runs on one case of each route and on the gap
checks; the reference's own method, mc, on the rest.

Heavy-tailed tables take the port's knot-exact inverse in the kernel
where the JAX package takes its XLA searchsorted sampler: the Student-t(5)
second moment is held to 5/3 within the reference's 0.1.

Then the routing left to later items: the CUSTOM MCMC workloads that the
JAX package sends to its XLA sweep rather than its kernels (a heavy-tailed
proposal, a target table with no uniform grid, a gapped tempered
proposal) raise naming items 6.8, 8.9 and 9.8, and the JAX package's
kernel gates refuse the same inputs; a seed-batched compile_integrate
over a CUSTOM dimension runs, each element its unbatched call; and a
density whose front-end construct the port lacks names item 3 rather than
take the table route (the reference traces it in closed form).
"""

import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.device import sampling_tables
from tpu_montecarlo_torch.ops.integrate_kernel import KnotTables, STRATA
from tpu_montecarlo_torch.sampling import dist_spec_of

D = tm.Distribution


def _integrate(fns, dist, n, seed=42, **kw):
    return tm.integrate(fns, dist, n_samples=n, seed=seed, device="cpu", **kw).values


def _is(fns, target, proposal, n, seed=42, **kw):
    return tm.integrate_importance_sampling(
        fns, target, proposal, n_samples=n, seed=seed, device="cpu", **kw).values


def _triangle(x):
    if 0 <= x <= 1:
        return x
    if 1 < x <= 2:
        return 2 - x
    return 0.0


def _gapped():
    x = np.linspace(0.0, 1.0, 2048)
    return D.from_pdf_table(x, np.where((x > 0.4) & (x < 0.6), 0.0, 1.0))


def _islands():
    x = np.linspace(-3.0, 3.0, 2048)
    return D.from_pdf_table(x, np.where((np.abs(x) > 1.0) & (np.abs(x) < 2.5), 1.0, 0.0))


def _untraceable(x):
    # An int() cast on a data value does not trace.
    return 0.5 if int(abs(x)) < 1 else 0.0


def _while_pdf(x):
    # A while loop: the JAX package traces it, the port's front end does
    # not yet (ROADMAP.md item 3).
    y = 0.0
    while y < 1.0:
        y = y + 1.0
    return 0.5 * y if abs(x) < 1.0 else 0.0


# name: (functions, distribution factory, n, {function index: (value, tol)})
MOMENTS = {
    "beta-2-5": ([lambda x: x, lambda x: (x - 2.0 / 7.0) ** 2], lambda: D.beta(2.0, 5.0),
                 1 << 20, {0: (2.0 / 7.0, 0.01), 1: (10.0 / 392.0, 0.01)}),
    "beta-3-2": ([lambda x: x], lambda: D.beta(3.0, 2.0), 1 << 20, {0: (0.6, 0.01)}),
    "beta-table-1024": ([lambda x: x], lambda: D.beta(2.0, 5.0, table_size=1024),
                        1 << 20, {0: (2.0 / 7.0, 0.02)}),
    "beta-table-4096": ([lambda x: x], lambda: D.beta(2.0, 5.0, table_size=4096),
                        1 << 20, {0: (2.0 / 7.0, 0.02)}),
    "triangular": ([lambda x: x], lambda: D.from_pdf(_triangle, support=(0.0, 2.0)),
                   1 << 20, {0: (1.0, 0.01)}),
    "table-uniform": ([lambda x: x, lambda x: x * x],
                      lambda: D.from_pdf(lambda x: 1.0 if 0 <= x < 1 else 0.0, support=(0.0, 1.0)),
                      1 << 20, {0: (0.5, 0.01), 1: (1.0 / 3.0, 0.01)}),
    "nan-sanitised": ([lambda x: x], lambda: D.from_pdf(
        lambda x: float("nan") if abs(x) > 0.9 else 1.0, support=(-1.0, 1.0)),
        500_000, {0: (0.0, 0.05)}),
    "inf-sanitised": ([lambda x: x], lambda: D.from_pdf(
        lambda x: float("inf") if abs(x) > 0.9 else 1.0, support=(-1.0, 1.0)),
        500_000, {0: (0.0, 0.05)}),
    "negative-clipped": ([lambda x: x], lambda: D.from_pdf(
        lambda x: -1.0 if abs(x) > 0.9 else 1.0, support=(-1.0, 1.0)),
        500_000, {0: (0.0, 0.05)}),
    "gapped-no-sample-in-gap": ([lambda x: x, lambda x: (x > 0.41) * (x < 0.59)], _gapped,
                                400_000, {0: (0.5, 0.02), 1: (0.0, 0.0)}),
    "bimodal-islands": ([lambda x: x, lambda x: x * x, lambda x: abs(x) < 0.99], _islands,
                        400_000, {0: (0.0, 0.03), 1: (3.25, 0.05), 2: (0.0, 0.0)}),
    "mixture-bimodal": ([lambda x: x, lambda x: x * x], lambda: D.mixture(
        [D.normal(-3.0, 1.0), D.normal(3.0, 1.0)], weights=(0.3, 0.7)),
        400_000, {0: (1.2, 0.05), 1: (10.0, 0.15)}),
    "mixture-uniform-exponential": ([lambda x: x], lambda: D.mixture(
        [D.uniform(0.0, 1.0), D.exponential(1.0)], weights=[0.5, 0.5]),
        400_000, {0: (0.75, 0.03)}),
    # Modes 16 sigma apart leave a zero-density gap (|x| < 0.306 here): no
    # sample inside it.  The reference's P(|x| < 4) < 1e-6 holds on its
    # knot-exact XLA route; its kernel's gap-respecting strata, and so the
    # port's, spread the last knot interval before each gap edge over the
    # band (1.77e-4 of samples at seed 4 in both): at most one knot
    # interval, 1 / (32 * 127), a side.
    "mixture-gap": ([lambda x: 1.0 * (abs(x) < 0.3), lambda x: 1.0 * (abs(x) < 4.0)],
                    lambda: D.mixture([D.normal(-8.0, 0.5), D.normal(8.0, 0.5)]),
                    400_000, {0: (0.0, 0.0), 1: (0.0, 2.0 / (STRATA * 127))}),
    "mixture-weight-split": ([lambda x: 1.0 * (x > 0.0)], lambda: D.mixture(
        [D.normal(-8.0, 0.5), D.normal(8.0, 0.5)], weights=[0.25, 0.75]),
        400_000, {0: (0.75, 0.01)}),
    "mixture-far-modes": ([lambda x: x, lambda x: x * x], lambda: D.mixture(
        [D.normal(-500.0, 1.0), D.normal(500.0, 1.0)]),
        1_000_000, {0: (0.0, 5.0), 1: (250001.0, 2500.01)}),
    "mixture-weights-normalised": ([lambda x: x], lambda: D.mixture(
        [D.normal(-2.0, 1.0), D.normal(2.0, 1.0)], weights=[2.0, 2.0]),
        200_000, {0: (0.0, 0.05)}),
    "gamma-small-shape": ([lambda x: 1.0 * (x > 0)], lambda: D.gamma(shape=0.5, rate=1.0),
                          200_000, {0: (1.0, 1e-3)}),
    "student-t-2-tail-mass": ([lambda x: 1.0 * (abs(x) > 5.0)], lambda: D.student_t(df=2.0),
                              1_000_000, {0: (2.0 * (0.5 - 0.5 * 5.0 / math.sqrt(27.0)),
                                              0.25 * 2.0 * (0.5 - 0.5 * 5.0 / math.sqrt(27.0)))}),
    "student-t-5-heavy-tail": ([lambda x: x * x], lambda: D.student_t(5.0),
                               500_000, {0: (5.0 / 3.0, 0.1)}),
}
# (factory, kwargs, mean, variance): tests/test_scipy_families.py's CASES.
SCIPY = [
    ("gamma", dict(shape=3.0, rate=2.0), 1.5, 0.75),
    ("gamma", dict(shape=1.0, rate=0.5), 2.0, 4.0),
    ("gamma", dict(shape=0.7, rate=1.0), 0.7, 0.7),
    ("student_t", dict(df=5.0), 0.0, 5.0 / 3.0),
    ("student_t", dict(df=12.0, loc=2.0, scale=0.5), 2.0, 0.25 * 1.2),
    ("chi2", dict(df=4.0), 4.0, 8.0),
]
for _name, _kw, _mean, _var in SCIPY:
    _second = _var + _mean * _mean
    MOMENTS[f"{_name}-{'-'.join(f'{v:g}' for v in _kw.values())}"] = (
        [lambda x: x, lambda x: x * x],
        lambda n=_name, k=_kw: getattr(D, n)(**k), 400_000,
        {0: (_mean, 0.05 * max(1.0, abs(_mean))),
         1: (_second, 0.08 * max(1.0, _second))})


# Every method on one case of each route and on the gap checks; mc (the
# reference's method) on the others.
ALL_METHODS = ("beta-2-5", "gapped-no-sample-in-gap", "mixture-gap",
               "student-t-5-heavy-tail")
MOMENT_RUNS = [(c, m) for c in MOMENTS for m in ("mc", "antithetic", "qmc")
               if m == "mc" or c in ALL_METHODS]


@pytest.mark.parametrize("case,method", MOMENT_RUNS,
                         ids=[f"{c}-{m}" for c, m in MOMENT_RUNS])
def test_reference_moments(case, method):
    fns, make, n, want = MOMENTS[case]
    got = _integrate(fns, make(), n, method=method)
    assert got.shape == (len(fns),) and np.all(np.isfinite(got))
    for j, (value, tol) in want.items():
        assert abs(got[j] - value) <= tol, (j, got[j], value, tol)


def test_heavy_tail_from_pdf_second_moment():
    # A user's heavy-tailed from_pdf density: the knot-exact route against
    # the table's own second moment, within the reference's 5 %.
    c = 8.0 / math.pi
    d = D.from_pdf(lambda x: c / (1.0 + x * x) ** 2.0, support=(-40.0, 40.0))
    spec = dist_spec_of(d)
    assert spec.exact_inverse and spec.heavy_tail
    got = _integrate([lambda x: x * x], d, 800_000, seed=21)[0]
    x = np.asarray(d._x_table, np.float64)
    dm = np.diff(np.asarray(d._cdf_table, np.float64))
    want = float((dm * (x[:-1] ** 2 + x[:-1] * x[1:] + x[1:] ** 2) / 3.0).sum())
    assert abs(got - want) < 0.05 * want


def test_gapped_heavy_tail_mixture():
    # tests/test_mixture.py's separated heavy-tailed modes, two Cauchy
    # components: both gapped and heavy, so the knot-exact route; the
    # median band holds.
    d = D.mixture([D.cauchy(-500.0, 1.0), D.cauchy(500.0, 1.0)])
    spec = dist_spec_of(d)
    assert spec.exact_inverse and spec.heavy_tail
    got = _integrate([lambda x: 1.0 * (x > 0.0), lambda x: 1.0 * (abs(x) < 400.0)],
                     d, 400_000, seed=12)
    assert abs(got[0] - 0.5) < 0.01
    assert abs(got[1] - (math.atan(900.0) - math.atan(100.0)) / math.pi) < 0.01


def _sampler_moment(dist, power):
    """E[X**power] (1 or 2) of the distribution the port samples: the
    piecewise-linear CDF over the knots on the knot-exact route; on the
    strata route x = ts + frac * dts, frac uniform, in each of the 32 x
    127 equal-mass knot intervals."""
    spec = dist_spec_of(dist)
    tables = sampling_tables(dist, spec, "cpu")
    if isinstance(tables, KnotTables):
        x = np.asarray(spec.x_table, np.float64)
        dm = np.diff(np.asarray(spec.cdf_table, np.float64))
        a, b = x[:-1], x[1:]
        m1, m2 = dm * (a + b) / 2.0, dm * (a * a + a * b + b * b) / 3.0
    else:
        t = tables.ts.double().numpy()[:, :-1]
        d = tables.dts.double().numpy()[:, :-1]
        m1, m2 = (t + d / 2.0) / t.size, (t * t + t * d + d * d / 3.0) / t.size
    return float((m1 if power == 1 else m2).sum())


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_stderr_covers_the_sampled_moments(method):
    # Error bars on each route (strata, gapped strata, knots): within 6 of
    # their own standard errors of the sampled distribution's moment
    # (rQMC's are ~1e-6: they see the resampled table's own mean).
    for dist, power in ((D.beta(2.0, 5.0), 1), (_gapped(), 1),
                        (D.student_t(5.0), 2)):
        r = tm.integrate([lambda x: x ** power], dist, n_samples=1 << 20,
                         method=method, return_stderr=True, device="cpu")
        assert r.stderr[0] > 0
        assert abs(r.values[0] - _sampler_moment(dist, power)) <= 6 * r.stderr[0]


# (target, proposal, function, value, tol): the non-traced IS cases.
IS_CASES = {
    "untraceable-target": (lambda: D.from_pdf(_untraceable, support=(-1.0, 1.0)),
                           lambda: D.uniform(-1.0, 1.0), lambda x: x * x, 1.0 / 3.0, 0.02),
    "untraceable-proposal": (lambda: D.uniform(-1.0, 1.0),
                             lambda: D.from_pdf(_untraceable, support=(-1.0, 1.0)),
                             lambda x: x * x, 1.0 / 3.0, 0.02),
    "both-untraceable": (lambda: D.from_pdf(_untraceable, support=(-1.0, 1.0)),
                         lambda: D.from_pdf(_untraceable, support=(-1.0, 1.0)),
                         lambda x: x * x, 1.0 / 3.0, 0.02),
    "pdf-table-target": (lambda: D.from_pdf_table(
        np.linspace(-1.0, 1.0, 1500), np.where(np.abs(np.linspace(-1.0, 1.0, 1500)) < 1.0, 0.5, 0.0)),
        lambda: D.normal(0.0, 1.0), lambda x: x * x, 1.0 / 3.0, 0.02),
    "arbitrary-table-size": (lambda: D.from_pdf_table(np.linspace(0.0, 1.0, 777),
                                                      2.0 * np.linspace(0.0, 1.0, 777)),
                             lambda: D.uniform(0.0, 1.0), lambda x: x, 2.0 / 3.0, 0.02),
    "gapped-proposal": (lambda: D.uniform(0.0, 1.0), _gapped, lambda x: x, 0.4, 0.02),
    "gamma-proposal": (lambda: D.exponential(1.0), lambda: D.gamma(shape=2.0, rate=1.0),
                       lambda x: x, 1.0, 0.05),
    "beta-target-table-proposal": (lambda: D.beta(2.0, 5.0),
                                   lambda: D.from_pdf(_triangle, support=(0.0, 2.0)),
                                   lambda x: x, 2.0 / 7.0, 0.02),
}


IS_RUNS = [(c, m) for c in IS_CASES for m in ("mc", "antithetic", "qmc")
           if m == "mc" or c in ("both-untraceable", "gapped-proposal")]


@pytest.mark.parametrize("case,method", IS_RUNS,
                         ids=[f"{c}-{m}" for c, m in IS_RUNS])
def test_reference_importance_sampling(case, method):
    target, proposal, fn, value, tol = IS_CASES[case]
    got = _is([fn], target(), proposal(), 1 << 20, method=method)
    assert abs(got[0] - value) < tol, got


def test_irregular_unnormalised_proposal_takes_the_closure_fallback():
    # A proposal table that no uniform grid represents within the bound
    # (a spike 1e-5 wide) and that is not self-normalised (its pdf twice
    # its CDF's density): the JAX package's closure fallback, whose table
    # lookups the port makes over the irregular grid by a knot search;
    # the face-value weights halve E_p[x] = 1/2.
    d = np.geomspace(1e-5, 1e-3, 60)
    x = np.unique(np.concatenate([np.linspace(0.0, 1.0, 300), 0.5 - d, 0.5 + d, [0.5]]))
    table = D.from_pdf_table(x, 1.0 + 50.0 * np.exp(-(((x - 0.5) / 1e-5) ** 2)))
    prop = D(tm.DistributionType.CUSTOM, dict(table.params), _untraceable,
             x_table=table._x_table, cdf_table=table._cdf_table,
             pdf_table=table._pdf_table * np.float32(2.0))
    integ = tm.MonteCarloIntegrator(device="cpu")
    weight = integ._is_weight(D.uniform(0.0, 1.0), prop)
    assert type(weight[1]).__name__ == "KnotWeightTable"
    got = integ.integrate_importance_sampling(
        [lambda t: t], D.uniform(0.0, 1.0), prop, n_samples=1 << 20).values
    assert abs(got[0] - 0.25) < 0.01


def test_diagnostics_with_table_weights():
    # The weight's diagnostics under a table weight: a normalised target
    # table gives a mean weight of about 1.
    r = tm.integrate_importance_sampling(
        [lambda x: x * x], D.from_pdf(_untraceable, support=(-1.0, 1.0)),
        D.uniform(-1.0, 1.0), n_samples=1 << 20, return_stderr=True,
        return_diagnostics=True, device="cpu")
    assert abs(r.values[0] - 1.0 / 3.0) < 0.02
    assert abs(r.diagnostics["mean_weight"] - 1.0) < 0.01
    assert 0 < r.diagnostics["ess"] <= 1 << 20


# -- what this slice leaves to later items --------------------------------------

_N = D.normal(0.0, 1.0)
_N2 = D.normal(0.0, 2.0)


def _beta():
    return D.beta(2.0, 5.0)


def _spike(pkg):
    """A table whose spike no uniform grid of up to 65,536 knots resolves:
    its log table has no uniform grid."""
    x = np.concatenate([np.linspace(-2.0, 0.0, 64), [1e-6, 2e-6],
                        np.linspace(0.01, 2.0, 64)])
    p = np.concatenate([np.full(64, 0.2), [50.0, 0.2], np.full(64, 0.2)])
    return pkg.Distribution.from_pdf_table(x, p)


def _gapped_wide(pkg):
    """A proposal with a zero-density gap that the JAX kernel samples
    (``tests/test_gapped_pallas.py:19``), on a wider support."""
    x = np.linspace(-6.0, 6.0, 2048)
    return pkg.Distribution.from_pdf_table(
        x, np.where(np.abs(x) < 1.0, 0.0, np.exp(-0.1 * x * x)))


def _mcmc(**kw):
    fns = kw.pop("fns", [lambda x: x])
    return tm.integrate_mcmc(fns, kw.pop("target"), kw.pop("proposal"), n_steps=10,
                             n_burnin=2, device="cpu", **kw)


_F2 = [lambda x, y: x * y]
_PT = dict(temperatures=[1.0, 2.0])

ROUTING = {
    "mcmc-heavy-proposal": (lambda: _mcmc(target=_N, proposal=D.student_t(5.0)),
                            r"item 6\.8"),
    "mcmc-gridless-target": (lambda: _mcmc(target=_spike(tm), proposal=_N2),
                             r"item 6\.8"),
    "nd-mcmc-heavy-proposal": (lambda: _mcmc(fns=_F2, target=[_N, _N],
                                             proposal=[_N2, D.student_t(5.0)]),
                               r"item 8\.9"),
    "nd-mcmc-gridless-target": (lambda: _mcmc(fns=_F2, target=[_spike(tm), _N],
                                              proposal=tm.RandomWalk()),
                                r"item 8\.9"),
    "tempered-gapped-proposal": (lambda: _mcmc(target=_N, proposal=_gapped_wide(tm), **_PT),
                                 r"item 9\.8"),
    "tempered-heavy-proposal": (lambda: _mcmc(target=_N, proposal=D.student_t(5.0),
                                              **_PT), r"item 9\.8"),
    "tempered-gridless-target": (lambda: _mcmc(target=_spike(tm), proposal=tm.RandomWalk(),
                                               **_PT), r"item 9\.8"),
    "while-density-target": (lambda: _is([lambda x: x], D(tm.DistributionType.CUSTOM, {}, _while_pdf),
                                         D.uniform(-1.0, 1.0), 1000), r"item 3 "),
    "while-density-proposal": (lambda: _is([lambda x: x], D.uniform(-1.0, 1.0),
                                           D.from_pdf(_while_pdf, support=(-1.0, 1.0)), 1000),
                               r"item 3 "),
}


# Items the port has since done: the MCMC kernels take the tables the JAX
# package sends to its XLA sweep (knot-exact proposals, irregular target
# tables, tempered gapped proposals), so the call returns its values.
TAKEN = (r"item 6\.8", r"item 8\.9", r"item 9\.8")


@pytest.mark.parametrize("case", list(ROUTING))
def test_left_to_later_items(case):
    call, item = ROUTING[case]
    if item in TAKEN:
        r = call()
        assert r.values.shape == (1,) and np.all(np.isfinite(r.values))
        assert 0.0 < r.acceptance_rate <= 1.0
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1 " + item):
        call()


def test_nd_custom_dimension_takes_a_seed_batch():
    """A seed-batched nd handle over a CUSTOM dimension, which raised
    before the serving handles: each element its unbatched handle's, and
    the public call's values as float32."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    dims, fns = [_N, _beta()], [lambda x, y: x * y]
    prog = integ.compile_integrate(fns, dims, n_samples=1 << 16, seed_batch=4)
    out = prog([1, 2, 3, 4])
    single = integ.compile_integrate(fns, dims, n_samples=1 << 16)
    for r, seed in enumerate([1, 2, 3, 4]):
        assert torch.equal(out[r], single(seed))
    want = integ.integrate(fns, dims, n_samples=1 << 16, seed=2).values
    np.testing.assert_array_equal(out[1].numpy(), want)


def test_the_jax_kernels_refuse_what_the_port_leaves_to_item_6_8():
    # The JAX package's kernel gates send the MCMC cases above to its XLA
    # sweep: a heavy-tailed proposal (``_mcmc_pallas_ok``, also the nd and
    # tempered gates), a target with no uniform-grid log table, and a
    # gapped proposal under tempering (``_pt_pallas_eligible``).
    from tpu_montecarlo.api.device import _uniform_log_tables
    from tpu_montecarlo.api.device import _proposal_kernel_log_tables

    assert j_dist_spec_of(jmc.Distribution.student_t(5.0)).heavy_tail
    assert _uniform_log_tables(_spike(jmc)) is None
    gapped = _gapped_wide(jmc)
    assert j_dist_spec_of(gapped).exact_inverse
    assert not j_dist_spec_of(gapped).heavy_tail
    # ... which the 1-D and nd kernels do take (tests/test_torch_mcmc_custom.py).
    assert _proposal_kernel_log_tables(gapped) is not None


def test_while_density_is_traced_by_the_reference():
    # Why the probe lets the front end's NotImplementedError through: the
    # JAX package traces this density and computes it in closed form, so a
    # table (interpolated) route would change the answer.
    integ = jmc.MonteCarloIntegrator()
    jd = jmc.Distribution(jmc.DistributionType.CUSTOM, {}, _while_pdf)
    assert integ._pdf_mode(jd)[0] == "traced"
    td = D(tm.DistributionType.CUSTOM, {}, _while_pdf)
    with pytest.raises(NotImplementedError, match="while loops"):
        tm.MonteCarloIntegrator(device="cpu")._pdf_mode(td)
    # A density that does not trace in either package takes the table.
    assert tm.MonteCarloIntegrator(device="cpu")._pdf_mode(
        D(tm.DistributionType.CUSTOM, {}, _untraceable))[0] == "table"
    assert integ._pdf_mode(jmc.Distribution(
        jmc.DistributionType.CUSTOM, {}, _untraceable))[0] == "table"


def test_specs_route_as_the_reference():
    # Which route each spec takes: the heavy-tail and gap flags equal the
    # JAX package's, the port's kernel takes every one.
    for make in (lambda p: p.Distribution.student_t(5.0),
                 lambda p: p.Distribution.beta(2.0, 5.0),
                 lambda p: p.Distribution.from_pdf(
                     lambda x: x * (2.0 - x) if 0 < x < 2 else 0.0, support=(0.0, 2.0))):
        j, t = j_dist_spec_of(make(jmc)), dist_spec_of(make(tm))
        assert (t.exact_inverse, t.heavy_tail) == (j.exact_inverse, j.heavy_tail)
