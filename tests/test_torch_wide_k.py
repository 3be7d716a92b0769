"""More than 128 functions in the port's integrate kernels: 1-D integrate,
importance sampling and nd integrate run in passes of at most 128
functions over the identical counter-keyed stream (``api/passes.py``, the
JAX package's multi-pass path, ``tpu_montecarlo/api/integrate.py:
1001-1098``).

On the CPU every pass is the plain version of its group.  The JAX
package's own multi-pass cases (``tests/test_round3_fixes.py:117-195``)
run on the port, 1-D and nd; each pass is held bit for bit against the
port's single launch over its group; and the 1-D mc means are held
against the JAX package's multi-pass in interpret mode, which keeps
256-row tiles for groups of 65-100 functions and so draws the port's
uniforms: within 1e-5, the tolerance of the K <= 128 comparison
(``tests/test_torch_integrate.py``).  Where the JAX package shrinks its
tiles (error bars, CUSTOM tables) or runs XLA (nd), the port is held
statistically: within 6 standard errors of the closed form.
"""

import math

import numpy as np
import pytest

import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.passes import build_all, cat_passes, split_groups

N = 1 << 15
N01 = tm.Distribution.normal(0.0, 1.0)
U01 = tm.Distribution.uniform(0.0, 1.0)


def _traced(fns, n_args):
    """The functions traced once each: the public calls take traced
    functions as they are, so a test's repeated calls do not parse this
    file once per lambda and call again."""
    return [tm.trace_function(f, n_args) for f in fns]


def _arity(dist):
    return len(dist) if isinstance(dist, list) else 1


def _square(x):
    return x * x


def _square_nd(x, y):
    return x * x + y


def _affine(c):
    return lambda x: x * x + c * x


def _affine_nd(c):
    return lambda x, y: x * x + c * y


def _power(j):
    return lambda x: x ** (j % 3)


def _power_nd(j):
    return lambda x, y: x ** (j % 3) * (y ** 0)


# name: (integrator call's distribution, one copy, a family of K
# functions, the power family)
SHAPES = {
    "1d": (N01, _square, _affine, _power, U01),
    "nd": ([N01, U01], _square_nd, _affine_nd, _power_nd, [U01, U01]),
}


@pytest.mark.parametrize("k,most", [(129, 128), (130, 128), (256, 128),
                                    (257, 128), (254, 127), (252, 126),
                                    (1000, 128), (5, 128)])
def test_split_is_the_jax_package_split(k, most):
    groups = split_groups(list(range(k)), most)
    n_groups = -(-k // most)
    size = -(-k // n_groups)
    assert len(groups) == n_groups
    assert [len(g) for g in groups[:-1]] == [size] * (n_groups - 1)
    assert sum(groups, ()) == tuple(range(k))
    assert max(len(g) for g in groups) <= most


def test_group_builds_and_outputs():
    """``build_all`` returns every group's build in order and raises a
    failed one (no pass falls back); ``cat_passes`` joins the passes on
    the function axis and keeps the first pass's shared outputs."""
    assert build_all([lambda i=i: i for i in range(5)]) == list(range(5))

    def failed():
        raise RuntimeError("nvcc failed on integrate.cu")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        build_all([lambda: 1, failed])
    a, b = torch.arange(6.0).reshape(2, 3), torch.arange(6.0, 10.0).reshape(2, 2)
    assert torch.equal(cat_passes([a, b]), torch.cat([a, b], dim=1))
    v, acc, se = cat_passes([(a, a[:, 0], None), (b, b[:, 0], None)],
                            first_of=(1,))
    assert v.shape == (2, 5) and torch.equal(acc, a[:, 0]) and se is None


@pytest.mark.parametrize("shape", list(SHAPES))
def test_passes_share_identical_samples(shape):
    """``test_passes_share_identical_samples``: 129 copies of one
    integrand, 65 + 64 in two passes, every value bit-equal."""
    dist, one, _, _, _ = SHAPES[shape]
    one = tm.trace_function(one, _arity(dist))
    r = tm.integrate([one] * 129, dist, n_samples=N, device="cpu")
    assert r.values.shape == (129,)
    assert np.all(r.values == r.values[0])
    assert abs(r.values[0] - (1.0 if shape == "1d" else 1.5)) < 0.05


@pytest.mark.parametrize("shape", list(SHAPES))
def test_multi_pass_qmc(shape):
    """``test_multi_pass_qmc``: 130 powers under qmc."""
    _, _, _, power, udist = SHAPES[shape]
    powers = _traced([power(j) for j in range(3)], _arity(udist))
    r = tm.integrate([powers[j % 3] for j in range(130)], udist,
                     n_samples=1 << 16, method="qmc", device="cpu")
    np.testing.assert_allclose(r.values[:3], [1.0, 0.5, 1 / 3], atol=1e-3)
    np.testing.assert_allclose(r.values[0], r.values[129 // 3 * 3], atol=1e-6)
    # x ** 0 is 1 wherever it is evaluated: every pass's draws agree.
    assert np.all(r.values[0::3] == 1.0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_multi_pass_seed_batch_and_stderr(shape):
    """``test_multi_pass_seed_batch_and_stderr``: (R, K) results, the same
    integrand equal in both passes, and each batched row bit-equal to
    its unbatched error-bar run."""
    dist, one, _, _, _ = SHAPES[shape]
    one = tm.trace_function(one, _arity(dist))
    integ = tm.MonteCarloIntegrator(device="cpu")
    prog = integ.compile_integrate([one] * 130, dist, n_samples=N,
                                   seed_batch=2, return_stderr=True)
    v, s = (t.numpy() for t in prog([4, 5]))
    assert v.shape == (2, 130) and s.shape == (2, 130)
    assert np.all(v[0] == v[0, 0]) and np.all(s[1] == s[1, 0])
    for row, seed in enumerate((4, 5)):
        r = integ.integrate([one] * 130, dist, n_samples=N, seed=seed,
                            return_stderr=True)
        np.testing.assert_array_equal(v[row], np.float32(r.values))
        np.testing.assert_array_equal(s[row], np.float32(r.stderr))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_k256_custom_histogram(shape):
    """``test_k256_custom_table_matches_xla``'s histogram: 256 bins over
    a CUSTOM table (the first dimension under nd), in two passes of 128,
    sum to 1 within 0.02 and follow the density."""
    d = tm.Distribution.from_pdf(lambda x: math.exp(-0.5 * x * x),
                                 support=(-5.0, 5.0))
    edges = np.linspace(-3.0, 3.0, 257)
    if shape == "1d":
        def make_bin(lo, hi):
            return lambda x: (x >= lo) & (x < hi)
        dist = d
    else:
        def make_bin(lo, hi):
            return lambda x, y: (x >= lo) * (x < hi) * (y < 2.0)
        dist = [d, U01]
    fns = _traced([make_bin(float(edges[i]), float(edges[i + 1]))
                   for i in range(256)], _arity(dist))
    r = tm.integrate(fns, dist, n_samples=100_000, seed=3, device="cpu")
    assert r.values.shape == (256,)
    assert abs(r.values.sum() - 1.0) < 0.02
    mid = 0.5 * (edges[:-1] + edges[1:])
    want = np.exp(-0.5 * mid * mid) / math.sqrt(2 * math.pi) * (6.0 / 256)
    n_act = 100_000
    assert np.all(np.abs(r.values - want) < 6 * np.sqrt(want / n_act) + 2e-4)


@pytest.mark.parametrize("method,stderr", [("mc", False), ("mc", True),
                                           ("antithetic", True),
                                           ("qmc", False)])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_each_pass_is_its_single_launch(shape, method, stderr):
    """Each group's values and error bars are the port's single launch
    over that group, bit for bit."""
    dist, _, family, _, _ = SHAPES[shape]
    fns = _traced([family(c / 16.0) for c in range(131)], _arity(dist))
    integ = tm.MonteCarloIntegrator(device="cpu")
    kw = dict(n_samples=N, seed=11, method=method, return_stderr=stderr)
    wide = integ.integrate(fns, dist, **kw)
    parts = [integ.integrate(list(g), dist, **kw)
             for g in split_groups(fns, 128)]
    assert [p.values.shape[0] for p in parts] == [66, 65]
    np.testing.assert_array_equal(
        wide.values, np.concatenate([p.values for p in parts]))
    if stderr:
        np.testing.assert_array_equal(
            wide.stderr, np.concatenate([p.stderr for p in parts]))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_param_batch_runs_in_passes(shape):
    """``param_batch`` over more than 128 functions multi-passes on the
    kernel (the JAX package sends it to XLA): each row its unbatched call
    under its Distribution, bit for bit."""
    dist, one, _, _, _ = SHAPES[shape]
    one = tm.trace_function(one, _arity(dist))
    integ = tm.MonteCarloIntegrator(device="cpu")
    rows = [tm.Distribution.normal(0.5, 1.5), tm.Distribution.normal(-1.0, 0.5)]
    if shape == "1d":
        dists, pack = rows, tm.pack_param_batch(rows)
    else:
        dists = [[r, U01] for r in rows]
        pack = tm.pack_param_batch_nd(dists)
    prog = integ.compile_integrate([one] * 130, dists[0], n_samples=N,
                                   seed_batch=2, param_batch=True,
                                   return_stderr=True)
    v, s = prog([7, 8], pack)
    assert v.shape == (2, 130) and s.shape == (2, 130)
    for r, (seed, dist) in enumerate(zip((7, 8), dists)):
        one_v, one_s = integ.compile_integrate(
            [one] * 130, dist, n_samples=N, return_stderr=True)(seed)
        assert torch.equal(v[r], one_v) and torch.equal(s[r], one_s)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_importance_sampling_runs_in_passes(shape):
    """1-D and nd importance sampling over 130 functions, with the
    weight's diagnostics column (131 in all): every pass carries the same
    weight; each group its single launch, bit for bit; the handle's seed
    batch its unbatched calls."""
    t = tm.Distribution.normal(0.0, 1.0)
    q = tm.Distribution.normal(0.5, 1.5)
    if shape == "1d":
        targ, prop = t, q
        fns = _traced([_affine(c / 16.0) for c in range(130)], 1)
    else:
        targ, prop = [t, U01], [q, U01]
        fns = _traced([_affine_nd(c / 16.0) for c in range(130)], 2)
    integ = tm.MonteCarloIntegrator(device="cpu")
    kw = dict(n_samples=N, seed=5, return_stderr=True)
    wide = integ.integrate_importance_sampling(fns, targ, prop, **kw)
    assert wide.values.shape == (130,) and wide.stderr.shape == (130,)
    parts = [integ.integrate_importance_sampling(list(g), targ, prop, **kw)
             for g in split_groups(fns, 128)]
    np.testing.assert_array_equal(
        wide.values, np.concatenate([p.values for p in parts]))
    np.testing.assert_array_equal(
        wide.stderr, np.concatenate([p.stderr for p in parts]))
    diag = integ.integrate_importance_sampling(fns, targ, prop,
                                               return_diagnostics=True, **kw)
    assert diag.values.shape == (130,)
    assert 0.9 < diag.diagnostics["mean_weight"] < 1.1
    # E[x^2 + c x] = 1 under N(0, 1); E[x^2 + c y] = 1 + c / 2 over nd.
    want = np.array([1.0 + (0.0 if shape == "1d" else c / 32.0)
                     for c in range(130)])
    assert np.all(np.abs(wide.values - want) < 6 * wide.stderr + 1e-6)
    prog = integ.compile_importance_sampling(fns, targ, prop, n_samples=N,
                                             seed_batch=2)
    v = prog([5, 6])
    assert v.shape == (2, 130)
    one = integ.compile_importance_sampling(fns, targ, prop, n_samples=N)
    assert torch.equal(v[1], one(6))


def test_means_match_the_jax_multi_pass_kernel():
    """1-D mc over N(0, 1), 130 functions: the JAX package's multi-pass
    in interpret mode (two groups of 65 at 256-row tiles) draws the
    port's uniforms, so the means agree within 1e-5 (measured 3.6e-7 at
    2^16)."""
    def mk(c):
        return lambda x: x * x + c * x

    fns = [mk(c / 10.0) for c in range(130)]
    want = jmc.MonteCarloIntegrator(backend="pallas").integrate(
        fns, jmc.Distribution.normal(0.0, 1.0), n_samples=1 << 16, seed=3)
    got = tm.integrate(_traced(fns, 1), N01, n_samples=1 << 16, seed=3,
                       device="cpu")
    assert got.values.shape == (130,)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-5)


def test_rqmc_rotations_run_in_passes():
    """rQMC error bars over 130 functions: the rotations' seed batch in
    passes, the same integrand equal in both."""
    r = tm.integrate([tm.trace_function(_square)] * 130, N01,
                     n_samples=1 << 16, method="qmc", return_stderr=True,
                     device="cpu")
    assert np.all(r.values == r.values[0]) and np.all(r.stderr == r.stderr[0])
    assert abs(r.values[0] - 1.0) < 6 * r.stderr[0] + 1e-4


def test_wide_sets_cache_one_program_per_group(program_cache):
    """A wide set caches one program per group, keyed by content: fresh
    but identical lambdas hit them."""
    def fresh():
        return [_affine(c / 8.0) for c in range(129)]

    tm.integrate(fresh(), N01, n_samples=1024, device="cpu")
    assert len(program_cache._store) == 2
    tm.integrate(fresh(), N01, n_samples=1024, device="cpu")
    assert len(program_cache._store) == 2
