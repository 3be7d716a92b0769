"""The port's host tables against the JAX package's, bit for bit.

``tpu_montecarlo_torch/tables.py`` is the port's own copy of the numpy
table numerics, and the CUSTOM factories of its ``distributions.py`` build
on it; ``ops/integrate_kernel.py`` recomputes the JAX kernel's stratified
and weight tables in float32.  Every table here must equal the JAX
package's exactly (``np.array_equal``, so also in dtype-rounded value and
NaN placement) on the same inputs, made from a seed with numpy.  Host
scalars (supports, flags) must be equal too.
"""

import math

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo import tables as jt
from tpu_montecarlo import distributions as jdist
from tpu_montecarlo.api import device as jdevice
from tpu_montecarlo.ops.integrate_pallas import (
    pad_uniform_table as j_pad_uniform_table,
    prep_inv_table_stratified as j_prep_inv_table_stratified,
)
from tpu_montecarlo.sampling import dist_spec_of as j_dist_spec_of

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch import distributions as tdist
from tpu_montecarlo_torch import tables as tt
from tpu_montecarlo_torch.api import device as tdevice
from tpu_montecarlo_torch.ops.integrate_kernel import (
    STRATA,
    pad_uniform_table,
    prep_inv_table_stratified,
)
from tpu_montecarlo_torch.sampling import dist_spec_of


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _gapped(pkg):
    x = np.linspace(0.0, 1.0, 2048)
    p = np.where((x > 0.4) & (x < 0.6), 0.0, 1.0)
    return pkg.Distribution.from_pdf_table(x, p)


def _irregular(pkg, seed=3):
    """A from_pdf_table density on an irregular grid, from a seed."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.2, 1.8, 600)) / 300.0
    p = np.exp(-((x - x.mean()) ** 2)) * (1.0 + 0.3 * np.sin(7.0 * x))
    return pkg.Distribution.from_pdf_table(x, p)


def _triangle(x):
    return 1.0 - abs(x - 1.0) if 0.0 <= x <= 2.0 else 0.0


# name: a factory taking the package; the same arguments on both sides.
FACTORIES = {
    "beta-2-5": lambda pkg: pkg.Distribution.beta(2.0, 5.0),
    "beta-3-2-1024": lambda pkg: pkg.Distribution.beta(3.0, 2.0, table_size=1024),
    "gamma-3-2": lambda pkg: pkg.Distribution.gamma(3.0, 2.0),
    "gamma-small-shape": lambda pkg: pkg.Distribution.gamma(0.7),
    "student-t-5": lambda pkg: pkg.Distribution.student_t(5.0),
    "student-t-12-loc": lambda pkg: pkg.Distribution.student_t(12.0, loc=2.0, scale=0.5),
    "student-t-far-loc": lambda pkg: pkg.Distribution.student_t(3.0, loc=1e8),
    "chi2-4": lambda pkg: pkg.Distribution.chi2(4.0),
    "mixture-bimodal": lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.normal(-3.0, 1.0), pkg.Distribution.normal(3.0, 1.0)],
        weights=(0.3, 0.7)),
    "mixture-gapped": lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.normal(-8.0, 0.5), pkg.Distribution.normal(8.0, 0.5)]),
    "mixture-far": lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.normal(-500.0, 1.0), pkg.Distribution.normal(500.0, 1.0)]),
    "mixture-uniform-exponential": lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.uniform(0.0, 1.0), pkg.Distribution.exponential(1.0)]),
    "mixture-of-tables": lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.student_t(1.0, loc=-500.0),
         pkg.Distribution.student_t(1.0, loc=500.0)]),
    "from-pdf-triangle-512": lambda pkg: pkg.Distribution.from_pdf(
        _triangle, support=(0.0, 2.0), table_size=512),
    "from-pdf-auto-support": lambda pkg: pkg.Distribution.from_pdf(
        lambda x: math.exp(-0.5 * (x - 3.0) ** 2)),
    "from-pdf-table": lambda pkg: pkg.Distribution.from_pdf_table(
        np.linspace(0.0, 1.0, 777), 2.0 * np.linspace(0.0, 1.0, 777)),
    "from-pdf-table-user-cdf": lambda pkg: pkg.Distribution.from_pdf_table(
        np.linspace(0.0, 1.0, 64), np.ones(64), cdf_table=np.linspace(0.0, 0.95, 64)),
    "from-pdf-table-gapped": _gapped,
    "from-pdf-table-irregular": _irregular,
}


@pytest.mark.parametrize("name", list(FACTORIES))
def test_factory_tables_bit_equal(name):
    want = FACTORIES[name](jmc)
    got = FACTORIES[name](tm)
    assert got.dist_type.name == want.dist_type.name == "CUSTOM"
    assert got.params == want.params
    _equal(got._x_table, want._x_table)
    _equal(got._cdf_table, want._cdf_table)
    if want._pdf_table is None:
        assert got._pdf_table is None
    else:
        _equal(got._pdf_table, want._pdf_table)
    for pair in zip(got.get_or_compute_pdf_table(), want.get_or_compute_pdf_table()):
        _equal(*pair)
    for q in (1e-4, 0.1, 0.5, 0.77, 1.0 - 1e-6):
        assert got.quantile(q) == want.quantile(q)
    xs = np.linspace(float(want._x_table[0]) - 1.0, float(want._x_table[-1]) + 1.0, 17)
    assert [got.pdf(float(x)) for x in xs] == [want.pdf(float(x)) for x in xs]


@pytest.mark.parametrize("name", list(FACTORIES))
def test_spec_bit_equal(name):
    want = j_dist_spec_of(FACTORIES[name](jmc))
    got = dist_spec_of(FACTORIES[name](tm))
    assert int(got.kind) == int(want.kind) == 3
    _equal(got.params, want.params)
    _equal(got.x_table, want.x_table)
    _equal(got.cdf_table, want.cdf_table)
    assert got.exact_inverse == want.exact_inverse
    assert got.heavy_tail == want.heavy_tail


@pytest.mark.parametrize("name", list(FACTORIES))
def test_from_reference_carries_the_tables(name):
    want = FACTORIES[name](jmc)
    got = tm.Distribution.from_reference(want)
    _equal(got._x_table, want._x_table)
    _equal(got._cdf_table, want._cdf_table)
    assert got.params == want.params and got._pdf_func is want._pdf_func
    s, w = dist_spec_of(got), j_dist_spec_of(want)
    _equal(s.x_table, w.x_table)
    assert (s.exact_inverse, s.heavy_tail) == (w.exact_inverse, w.heavy_tail)


@pytest.mark.parametrize("with_pdf", [False, True], ids=["values", "with-pdf"])
@pytest.mark.parametrize("name", ["beta-2-5", "gamma-3-2", "mixture-bimodal",
                                  "from-pdf-triangle-512", "from-pdf-table-irregular"])
def test_stratified_tables_bit_equal(name, with_pdf):
    spec = j_dist_spec_of(FACTORIES[name](jmc))
    want = j_prep_inv_table_stratified(spec.x_table, 256, with_pdf=with_pdf)
    got = prep_inv_table_stratified(spec.x_table, 256, with_pdf=with_pdf)
    assert len(got) == len(want) == (3 if with_pdf else 2)
    for g, w in zip(got, want):
        # The JAX tables repeat each stratum's row over its 8 block rows.
        assert g.shape == (STRATA, 128)
        _equal(np.repeat(g, 256 // STRATA, axis=0), np.asarray(w))


@pytest.mark.parametrize("m,rows", [(4096, 256), (4096, 64), (700, 256), (2, 256)])
def test_stratified_strata_count_bit_equal(m, rows):
    rng = np.random.default_rng(m + rows)
    x = np.sort(rng.normal(size=m)).astype(np.float32)
    want = j_prep_inv_table_stratified(x, rows)
    got = prep_inv_table_stratified(x, rows)
    rep = rows // got[0].shape[0]
    for g, w in zip(got, want):
        _equal(np.repeat(g, rep, axis=0), np.asarray(w))


def test_stratified_argument_errors_match():
    x = np.linspace(0.0, 1.0, 4096, dtype=np.float32)
    for args in [(x[:1], 256), (x, 256, 64), (x, 256, 3)]:
        with pytest.raises(ValueError) as want:
            j_prep_inv_table_stratified(*args)
        with pytest.raises(ValueError) as got:
            prep_inv_table_stratified(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [2, 128, 1000, 2048, 2049])
def test_pad_uniform_table_bit_equal(n):
    rng = np.random.default_rng(n)
    xs = np.linspace(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(0.0, 2.0, n).astype(np.float32)
    wv, wdx, wgrid = (np.asarray(a) for a in j_pad_uniform_table(xs, v, 0.0))
    gv, gdx, ggrid = pad_uniform_table(xs, v)
    _equal(gv, wv.reshape(-1))
    _equal(gdx, wdx.reshape(-1))
    _equal(np.asarray(ggrid, np.float32), wgrid[0, :3])


@pytest.mark.parametrize("name", ["from-pdf-table-gapped", "mixture-gapped"])
def test_gapped_tables_bit_equal(name):
    jd, td = FACTORIES[name](jmc), FACTORIES[name](tm)
    jspec, tspec = j_dist_spec_of(jd), dist_spec_of(td)
    assert jspec.exact_inverse and tspec.exact_inverse
    _, pdf = jd.get_or_compute_pdf_table()
    want_gaps = jt.find_zero_density_gaps(jspec.x_table, jspec.cdf_table, pdf)
    got_gaps = tt.find_zero_density_gaps(tspec.x_table, tspec.cdf_table, pdf)
    assert got_gaps == want_gaps and len(got_gaps) >= 1
    for g, w in zip(tt.gapped_inverse_tables(tspec.x_table, tspec.cdf_table, got_gaps),
                    jt.gapped_inverse_tables(jspec.x_table, jspec.cdf_table, want_gaps)):
        _equal(g, w)
    for g, w in zip(tt.gapped_stratified_tables(tspec.x_table, tspec.cdf_table,
                                                got_gaps, segments=STRATA),
                    jt.gapped_stratified_tables(jspec.x_table, jspec.cdf_table,
                                                want_gaps, segments=STRATA)):
        _equal(g, w)
    # The staged tables: the JAX package's at its kernel's 256 // 8 strata.
    want = jdevice._device_gapped_tables(jd, jspec, stratified=True, segments=STRATA)
    got = tdevice._device_gapped_tables(td, tspec)
    for g, w in zip(got, want):
        _equal(g, np.asarray(w))


def test_two_gaps_snapping_to_one_knot_bit_equal():
    # tests/test_gapped_pallas.py's two gaps that snap to one u-knot.
    x = np.linspace(0.0, 1.0, 8192)
    p = np.ones_like(x)
    p[(x > 0.40) & (x < 0.45)] = 0.0
    p[(x > 0.4502) & (x < 0.60)] = 0.0
    jd, td = jmc.Distribution.from_pdf_table(x, p), tm.Distribution.from_pdf_table(x, p)
    js, ts = j_dist_spec_of(jd), dist_spec_of(td)
    gaps = jt.find_zero_density_gaps(js.x_table, js.cdf_table, jd.get_or_compute_pdf_table()[1])
    assert len(gaps) == 2
    for g, w in zip(tt.gapped_inverse_tables(ts.x_table, ts.cdf_table, gaps),
                    jt.gapped_inverse_tables(js.x_table, js.cdf_table, gaps)):
        _equal(g, w)


# Scalar PDFs for support detection: each probe phase and edge case of
# find_support (tests/test_distributions.py's TestSupportDetection).
def _nan_outside(x):
    return math.sqrt(1.0 - x * x) if abs(x) <= 1.0 else float("nan")


def _raises_outside(x):
    if x < 0.0:
        raise ValueError("outside")
    return math.exp(-x)


def _pole(x):
    return float("inf") if x == 0.0 else (math.exp(-abs(x)) / math.sqrt(abs(x)))


SUPPORT_PDFS = {
    "normal": lambda x: math.exp(-0.5 * x * x),
    "bounded": lambda x: x * (1.0 - x) if 0.0 < x < 1.0 else 0.0,
    "shifted": lambda x: math.exp(-0.5 * (x - 257.0) ** 2),
    "nan-outside": _nan_outside,
    "raises-outside": _raises_outside,
    "inf-pole": _pole,
    "wide": lambda x: 1.0 / (1.0 + (x / 50.0) ** 2),
}


@pytest.mark.parametrize("name", list(SUPPORT_PDFS))
def test_find_support_equal(name):
    assert tt.find_support(SUPPORT_PDFS[name]) == jt.find_support(SUPPORT_PDFS[name])


def test_find_support_error_matches():
    with pytest.raises(ValueError) as want:
        jt.find_support(lambda x: 0.0)
    with pytest.raises(ValueError) as got:
        tt.find_support(lambda x: 0.0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["normal", "bounded", "nan-outside", "inf-pole"])
@pytest.mark.parametrize("n", [10, 1000, 2048])
def test_cdf_and_pdf_tables_bit_equal(name, n):
    pdf = SUPPORT_PDFS[name]
    lo, hi = jt.find_support(pdf)
    wx, wc = jt.compute_cdf_table(pdf, lo, hi, n)
    gx, gc = tt.compute_cdf_table(pdf, lo, hi, n)
    _equal(gx, wx)
    _equal(gc, wc)
    _equal(tt.compute_pdf_table(pdf, wx), jt.compute_pdf_table(pdf, wx))
    for m in (4096, 257):
        _equal(tt.compute_inverse_cdf_table(wx, wc, m),
               jt.compute_inverse_cdf_table(wx, wc, m))


@pytest.mark.parametrize("seed", range(4))
def test_table_predicates_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 3000))
    x = np.sort(rng.normal(scale=rng.uniform(0.5, 20.0), size=n))
    p = np.abs(rng.standard_cauchy(n)) if seed % 2 else rng.uniform(0.0, 1.0, n)
    p[rng.integers(0, n, n // 7)] = 0.0
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (p[1:] + p[:-1]) * np.diff(x))])
    cdf /= cdf[-1]
    inv = jt.compute_inverse_cdf_table(x, cdf)
    _equal(tt.compute_inverse_cdf_table(x, cdf), inv)
    assert tt._effective_support_slice(cdf) == jt._effective_support_slice(cdf)
    assert tt.needs_exact_inverse(cdf, p) == jt.needs_exact_inverse(cdf, p)
    assert tt.inverse_table_distorts(x, cdf, inv) == jt.inverse_table_distorts(x, cdf, inv)
    a, b = inv[:-1], inv[1:]
    assert tt.sample_intervals_distort(x, cdf, a, b) == jt.sample_intervals_distort(x, cdf, a, b)
    assert tt.is_uniform_grid(x) == jt.is_uniform_grid(x)
    assert tt.is_uniform_grid(np.linspace(0, 1, n)) == jt.is_uniform_grid(np.linspace(0, 1, n))
    assert tt.find_zero_density_gaps(x, cdf, p) == jt.find_zero_density_gaps(x, cdf, p)
    for rtol in (1e-3, 1e-2):
        got, want = tt.resample_uniform_table(x, p, rtol), jt.resample_uniform_table(x, p, rtol)
        assert (got is None) == (want is None)
        if want is not None:
            _equal(got[0], want[0])
            _equal(got[1], want[1])
    xu = np.linspace(-3.0, 4.0, 4096).astype(np.float32)
    vu = (np.exp(-xu * xu) * (1.0 + 0.1 * rng.uniform(size=4096))).astype(np.float32)
    for relative in (False, True):
        for g, w in zip(tt.downsample_pdf_table(xu, vu, relative=relative),
                        jt.downsample_pdf_table(xu, vu, relative=relative)):
            _equal(g, w)


def test_knot_helpers_bit_equal():
    rng = np.random.default_rng(11)
    for n, eps in ((2048, 1e-7), (64, 1e-6), (5, 1e-3)):
        _equal(tdist._quantile_levels(n, eps), jdist._quantile_levels(n, eps))
    x = np.concatenate([rng.normal(-500.0, 1.0, 300), rng.normal(500.0, 1.0, 300),
                        [np.inf, np.nan, 1e39]])
    _equal(tdist._dedupe_knots_f32(x), jdist._dedupe_knots_f32(x))
    knots = jdist._dedupe_knots_f32(x)
    _equal(tdist._subdivide_wide_cells(knots), jdist._subdivide_wide_cells(knots))
    _equal(tdist._subdivide_wide_cells(knots[:2]), jdist._subdivide_wide_cells(knots[:2]))


def _errors(pkg, call):
    try:
        call(pkg)
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


ARG_ERRORS = {
    "2-d": lambda pkg: pkg.Distribution.from_pdf_table(np.ones((2, 2)), np.ones((2, 2))),
    "length": lambda pkg: pkg.Distribution.from_pdf_table([0.0, 1.0], [1.0, 1.0, 1.0]),
    "short": lambda pkg: pkg.Distribution.from_pdf_table([0.0], [1.0]),
    "unsorted": lambda pkg: pkg.Distribution.from_pdf_table([0.0, 2.0, 1.0], [1.0] * 3),
    "negative": lambda pkg: pkg.Distribution.from_pdf_table([0.0, 1.0], [1.0, -0.5]),
    "non-finite": lambda pkg: pkg.Distribution.from_pdf_table([0.0, 1.0], [1.0, np.inf]),
    "all-zero": lambda pkg: pkg.Distribution.from_pdf_table(np.linspace(0, 1, 50), np.zeros(50)),
    "cdf-length": lambda pkg: pkg.Distribution.from_pdf_table(
        [0.0, 1.0], [1.0, 1.0], cdf_table=[0.0, 0.5, 1.0]),
    "cdf-non-monotone": lambda pkg: pkg.Distribution.from_pdf_table(
        [0.0, 0.5, 1.0], [1.0] * 3, cdf_table=[0.0, 0.8, 0.5]),
    "cdf-zero": lambda pkg: pkg.Distribution.from_pdf_table(
        [0.0, 0.5, 1.0], [1.0] * 3, cdf_table=[0.0, 0.0, 0.0]),
    "from-pdf-not-callable": lambda pkg: pkg.Distribution.from_pdf("not callable"),
    "from-pdf-zero": lambda pkg: pkg.Distribution.from_pdf(lambda x: 0.0, support=(0.0, 1.0)),
    "gamma-shape": lambda pkg: pkg.Distribution.gamma(shape=0.0),
    "gamma-rate": lambda pkg: pkg.Distribution.gamma(shape=1.0, rate=-1.0),
    "student-t-df": lambda pkg: pkg.Distribution.student_t(df=-2.0),
    "student-t-scale": lambda pkg: pkg.Distribution.student_t(df=3.0, scale=0.0),
    "student-t-float32": lambda pkg: pkg.Distribution.student_t(df=3.0, loc=1e39),
    "mixture-one": lambda pkg: pkg.Distribution.mixture([pkg.Distribution.normal(0.0, 1.0)]),
    "mixture-type": lambda pkg: pkg.Distribution.mixture([pkg.Distribution.normal(0.0, 1.0), 3.0]),
    "mixture-weights-shape": lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.normal(0.0, 1.0), pkg.Distribution.normal(2.0, 1.0)], weights=[1.0]),
    "mixture-weights-sign": lambda pkg: pkg.Distribution.mixture(
        [pkg.Distribution.normal(0.0, 1.0), pkg.Distribution.normal(2.0, 1.0)],
        weights=[1.0, -1.0]),
    "custom-without-tables": lambda pkg: pkg.Distribution(
        pkg.DistributionType.CUSTOM, {}, lambda x: 1.0).quantile(0.5),
}


@pytest.mark.parametrize("case", list(ARG_ERRORS))
def test_argument_errors_word_for_word(case):
    assert _errors(tm, ARG_ERRORS[case]) == _errors(jmc, ARG_ERRORS[case])


def test_table_weight_modes_equal():
    # The uniform-grid pdf tables of importance weights, as staged for the
    # kernel: resampled where the grid is irregular (the proposal role
    # relative-validated), then downsampled.
    for make in (_irregular, lambda pkg: pkg.Distribution.beta(2.0, 5.0), _gapped):
        jd, td = make(jmc), make(tm)
        for role in ("target", "proposal"):
            mode = ("table",) + tuple(jd.get_or_compute_pdf_table())
            want = jdevice._uniform_table_mode(jd, mode, role)
            got = tdevice._uniform_table_mode(td, mode, role)
            assert (got is None) == (want is None)
            if want is None:
                continue
            _equal(got[1], want[1])
            _equal(got[2], want[2])
            jx, jv = jdevice._device_mode_tables(jd, want, role)
            tx, tv = tdevice._device_mode_tables(td, got, role)
            _equal(tx, np.asarray(jx))
            _equal(tv, np.asarray(jv))
