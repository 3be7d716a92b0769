"""The port's 1-D serving handles: ``compile_integrate`` and
``compile_importance_sampling`` with seed and param batches.

On the CPU a handle runs the plain PyTorch version rep by rep, so each
element of a batched handle is its unbatched handle's result, bit for
bit (``torch.equal``), and an unbatched handle gives ``integrate()``'s
values as float32.  The CUDA kernel's batch axis is held to the same
equalities in ``test_torch_cuda.py``.

Against the JAX package, each handle is held to
``jmc.MonteCarloIntegrator(backend="pallas")``'s handle in interpret mode
on the same seeds and rows: means within 1e-5 absolute plus 1e-5
relative (``tests/test_torch_integrate_variants.py``), error bars within
1e-3 relative plus 1e-9 absolute, importance-sampling sets within the
same (their weights 2e-6 relative apart per value,
``tests/test_torch_importance.py``).  Sizes stay at 2**16 samples, a few
tiles, so the interpreter stays quick.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm

N = 1 << 16
SEEDS = [7, 42, 2**32 - 5]
FNS = [lambda x: x, lambda x: x * x, lambda x: x > 1.0]
MEAN_TOL = dict(rtol=1e-5, atol=1e-5)
STDERR_TOL = dict(rtol=1e-3, atol=1e-9)

# Every closed-form family, two rows each: (factory, [params, params]).
FAMILY_ROWS = {
    "uniform": [(-1.0, 2.0), (0.5, 4.0)],
    "normal": [(0.5, 1.5), (-2.0, 0.25)],
    "exponential": [(2.0,), (0.5,)],
    "lognormal": [(0.0, 0.5), (0.3, 0.7)],
    "cauchy": [(0.0, 1.0), (0.3, 1.7)],
    "laplace": [(3.0, 1.0), (-0.7, 0.3)],
    "logistic": [(0.0, 2.0), (1.3, 0.6)],
    "gumbel": [(1.0, 0.5), (-2.0, 3.0)],
    "weibull": [(1.5, 2.0), (0.5, 1.0)],
    "pareto": [(1.0, 3.0), (0.5, 1.2)],
}
# Bounded integrands, so that the heavy-tailed families' means compare.
BOUNDED = [lambda x: np.tanh(x), lambda x: x > 1.0]


def _port():
    return tm.MonteCarloIntegrator(device="cpu")


def _jax():
    return jmc.MonteCarloIntegrator(backend="pallas")


def _np(out):
    """A handle's result as float64 numpy (tuples elementwise)."""
    if isinstance(out, tuple):
        return tuple(_np(o) for o in out)
    return np.asarray(out, np.float64)


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == torch.float32
    assert torch.equal(got, want), (got, want)


def _close_to_jax(got, want, stderr: bool):
    if stderr:
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), **MEAN_TOL)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), **STDERR_TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **MEAN_TOL)


MODES = [("mc", False), ("mc", True), ("antithetic", False),
         ("antithetic", True), ("qmc", False)]


@pytest.mark.parametrize("method,stderr", MODES,
                         ids=[f"{m}{'-stderr' if s else ''}" for m, s in MODES])
def test_seed_batch_is_its_unbatched_calls(method, stderr):
    d = tm.Distribution.normal(0.5, 1.5)
    kw = dict(n_samples=N, method=method, return_stderr=stderr)
    batched = _port().compile_integrate(FNS, d, seed_batch=len(SEEDS), **kw)
    single = _port().compile_integrate(FNS, d, **kw)
    out = batched(SEEDS)
    for r, seed in enumerate(SEEDS):
        one = single(seed)
        _equal(tuple(o[r] for o in out) if stderr else out[r], one)
        # The unbatched handle is integrate()'s run, as float32.
        ref = tm.integrate(FNS, d, n_samples=N, seed=seed, method=method,
                           return_stderr=stderr, device="cpu")
        values = one[0] if stderr else one
        np.testing.assert_array_equal(values.numpy(), ref.values)
        if stderr:
            np.testing.assert_array_equal(one[1].numpy(), ref.stderr)
    shape = (len(SEEDS), len(FNS))
    assert (out[0].shape if stderr else out.shape) == shape


@pytest.mark.parametrize("method,stderr", MODES,
                         ids=[f"{m}{'-stderr' if s else ''}" for m, s in MODES])
def test_seed_batch_matches_the_jax_handle(method, stderr):
    kw = dict(n_samples=N, method=method, return_stderr=stderr,
              seed_batch=len(SEEDS))
    got = _port().compile_integrate(FNS, tm.Distribution.normal(0.5, 1.5),
                                    **kw)(SEEDS)
    want = _jax().compile_integrate(FNS, jmc.Distribution.normal(0.5, 1.5),
                                    **kw)(SEEDS)
    _close_to_jax(got, want, stderr)


@pytest.mark.parametrize("family", list(FAMILY_ROWS))
def test_param_batch_over_each_family(family):
    """Each row of a param batch is the unbatched handle under its
    Distribution; the batch is the JAX handle's within tolerance."""
    rows = FAMILY_ROWS[family]
    seeds = SEEDS[:len(rows)]

    def dists(pkg):
        return [getattr(pkg.Distribution, family)(*p) for p in rows]

    kw = dict(n_samples=N, seed_batch=len(rows), param_batch=True)
    prog = _port().compile_integrate(BOUNDED, dists(tm)[0], **kw)
    out = prog(seeds, tm.pack_param_batch(dists(tm)))
    assert out.shape == (len(rows), len(BOUNDED))
    for r, (seed, dist) in enumerate(zip(seeds, dists(tm))):
        _equal(out[r], _port().compile_integrate(BOUNDED, dist,
                                                 n_samples=N)(seed))
    jprog = _jax().compile_integrate(BOUNDED, dists(jmc)[0], **kw)
    want = jprog(seeds, jmc.pack_param_batch(dists(jmc)))
    np.testing.assert_allclose(_np(out), _np(want), **MEAN_TOL)


@pytest.mark.parametrize("method", ["mc", "antithetic"])
def test_param_batch_with_error_bars(method):
    """Each row runs under its own pilot: its values and error bars are
    the unbatched error-bar handle's; R = 1 keeps the batch axis."""
    dists = [tm.Distribution.normal(m, s) for m, s in ((0.0, 1.0), (2.0, 0.5),
                                                      (-1.0, 3.0))]
    kw = dict(n_samples=N, method=method, return_stderr=True)
    prog = _port().compile_integrate(FNS, dists[0], seed_batch=3,
                                     param_batch=True, **kw)
    values, stderr = prog(SEEDS, tm.pack_param_batch(dists))
    for r, (seed, dist) in enumerate(zip(SEEDS, dists)):
        _equal((values[r], stderr[r]),
               _port().compile_integrate(FNS, dist, **kw)(seed))
    one = _port().compile_integrate(FNS, dists[1], seed_batch=1,
                                    param_batch=True, **kw)
    v1, s1 = one([SEEDS[1]], tm.pack_param_batch(dists[1:2]))
    assert v1.shape == s1.shape == (1, len(FNS))
    _equal((v1[0], s1[0]), (values[1], stderr[1]))
    jdists = [jmc.Distribution.normal(m, s) for m, s in ((0.0, 1.0), (2.0, 0.5),
                                                        (-1.0, 3.0))]
    want = _jax().compile_integrate(FNS, jdists[0], seed_batch=3,
                                    param_batch=True, **kw)(
        SEEDS, jmc.pack_param_batch(jdists))
    _close_to_jax((values, stderr), want, True)


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_custom_table_under_a_seed_batch(method):
    kw = dict(n_samples=N, method=method)
    beta = tm.Distribution.beta(2.0, 5.0)
    batched = _port().compile_integrate([lambda x: x, lambda x: x * x], beta,
                                        seed_batch=2, **kw)
    single = _port().compile_integrate([lambda x: x, lambda x: x * x], beta,
                                       **kw)
    out = batched([3, 4])
    _equal(out[0], single(3))
    _equal(out[1], single(4))
    want = _jax().compile_integrate([lambda x: x, lambda x: x * x],
                                    jmc.Distribution.beta(2.0, 5.0),
                                    seed_batch=2, **kw)([3, 4])
    np.testing.assert_allclose(_np(out), _np(want), **MEAN_TOL)


@pytest.mark.parametrize("batch", ["seeds", "params"])
def test_qmc_handle_takes_in_kernel_error_bars(batch):
    """method="qmc" with return_stderr: the kernel's pilot-shifted squares
    under the seed-rotated radical inverse, as the JAX handle gives them
    (integrate()'s rotations are another estimate); each element is its
    unbatched handle's, bit for bit."""
    dists = [tm.Distribution.normal(0.5, 1.5), tm.Distribution.normal(-1.0, 0.5),
             tm.Distribution.normal(2.0, 3.0)]
    kw = dict(n_samples=N, method="qmc", return_stderr=True, seed_batch=3)
    if batch == "params":
        prog = _port().compile_integrate(FNS, dists[0], param_batch=True, **kw)
        out = prog(SEEDS, tm.pack_param_batch(dists))
    else:
        out = _port().compile_integrate(FNS, dists[0], **kw)(SEEDS)
    assert out[0].shape == out[1].shape == (3, len(FNS))
    for r, seed in enumerate(SEEDS):
        dist = dists[r] if batch == "params" else dists[0]
        one = _port().compile_integrate(FNS, dist, n_samples=N, method="qmc",
                                        return_stderr=True)(seed)
        _equal((out[0][r], out[1][r]), one)
    jd = [jmc.Distribution.normal(0.5, 1.5), jmc.Distribution.normal(-1.0, 0.5),
          jmc.Distribution.normal(2.0, 3.0)]
    if batch == "params":
        want = _jax().compile_integrate(FNS, jd[0], param_batch=True, **kw)(
            SEEDS, jmc.pack_param_batch(jd))
    else:
        want = _jax().compile_integrate(FNS, jd[0], **kw)(SEEDS)
    _close_to_jax(out, want, True)


@pytest.mark.parametrize("n", [1, 2, 300, 1024])
def test_fixed_sum_gives_each_slice_the_same_bits_in_any_batch(n):
    """The MCMC finish's and the pilots' sums: a slice's bits depend on
    the slice alone (torch's own reduction picks its order by the batch's
    shape), and the sum is within float32 rounding of a float64 one."""
    from tpu_montecarlo_torch.ops.reduce import fixed_sum

    x = torch.from_numpy(
        np.random.default_rng(n).standard_normal((5, n, 7)).astype(np.float32))
    whole = fixed_sum(x, 1)
    assert whole.shape == (5, 7)
    for r in range(5):
        assert torch.equal(fixed_sum(x[r:r + 1], 1)[0], whole[r])
        assert torch.equal(fixed_sum(x[r], 0), whole[r])
    np.testing.assert_allclose(whole.double().numpy(),
                               x.double().sum(dim=1).numpy(),
                               rtol=0, atol=1e-6 * n)


def test_seed_batch_of_a_tensor_and_of_one():
    d = tm.Distribution.uniform(0.0, 1.0)
    batched = _port().compile_integrate(FNS, d, n_samples=N, seed_batch=2)
    out = batched([5, 2**32 - 1])
    _equal(batched(torch.tensor([5, 2**32 - 1], dtype=torch.int64)), out)
    _equal(batched(np.array([5, 2**32 - 1], np.uint32)), out)
    single = _port().compile_integrate(FNS, d, n_samples=N)
    assert single(5).shape == (len(FNS),)
    _equal(out[1], single(2**32 - 1))


def test_rqmc_is_one_batched_launch_of_the_rotations():
    """integrate(method="qmc", return_stderr=True): the rotations' values
    are a seed-batched qmc handle's over the rotation seeds, bit for bit;
    the values and error bars their mean and spread."""
    d, r, n, seed = tm.Distribution.exponential(2.0), 4, 1 << 18, 11
    got = tm.integrate(FNS, d, n_samples=n, seed=seed, method="qmc",
                       return_stderr=True, qmc_rotations=r, device="cpu")
    words = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(r, dtype=np.uint32)
    single = _port().compile_integrate(FNS, d, n_samples=-(-n // r),
                                       method="qmc")
    vals = np.stack([single(int(w)).numpy() for w in words]).astype(np.float64)
    np.testing.assert_array_equal(got.values, vals.mean(axis=0))
    np.testing.assert_array_equal(got.stderr,
                                  vals.std(axis=0, ddof=1) / np.sqrt(r))
    batched = _port().compile_integrate(FNS, d, n_samples=-(-n // r),
                                        method="qmc", seed_batch=r)
    np.testing.assert_array_equal(batched(words).numpy(), vals)


# -- importance sampling --------------------------------------------------------

IS_PAIRS = {
    "closed-form": lambda pkg: ([lambda x: x * x], pkg.Distribution.normal(0.0, 1.0),
                                pkg.Distribution.normal(0.0, 2.0)),
    "rare-event": lambda pkg: ([lambda x: x > 3.0], pkg.Distribution.normal(0.0, 1.0),
                               pkg.Distribution.normal(3.5, 1.5)),
}


@pytest.mark.parametrize("method,stderr", MODES,
                         ids=[f"{m}{'-stderr' if s else ''}" for m, s in MODES])
@pytest.mark.parametrize("pair", list(IS_PAIRS))
def test_importance_handle(pair, method, stderr):
    fns, target, proposal = IS_PAIRS[pair](tm)
    kw = dict(n_samples=N, method=method, return_stderr=stderr)
    batched = _port().compile_importance_sampling(fns, target, proposal,
                                                  seed_batch=3, **kw)
    single = _port().compile_importance_sampling(fns, target, proposal, **kw)
    out = batched(SEEDS)
    for r, seed in enumerate(SEEDS):
        one = single(seed)
        _equal(tuple(o[r] for o in out) if stderr else out[r], one)
    ref = tm.integrate_importance_sampling(
        fns, target, proposal, n_samples=N, seed=SEEDS[0], method=method,
        return_stderr=stderr, device="cpu")
    np.testing.assert_array_equal(
        (out[0][0] if stderr else out[0]).numpy(), ref.values)
    jfns, jt, jq = IS_PAIRS[pair](jmc)
    want = _jax().compile_importance_sampling(jfns, jt, jq, seed_batch=3,
                                              **kw)(SEEDS)
    _close_to_jax(out, want, stderr)


def test_importance_handle_over_a_table_density():
    """A target whose density does not trace: its pdf table is made once,
    for the handle, and read in the kernel."""

    def tri(x):
        return x if 0 <= x <= 1 else (2 - x if 1 < x <= 2 else 0.0)

    target = tm.Distribution.from_pdf(tri, support=(0.0, 2.0))
    proposal = tm.Distribution.uniform(0.0, 2.0)
    fns = [lambda x: x, lambda x: x * x]
    batched = _port().compile_importance_sampling(fns, target, proposal,
                                                  n_samples=N, seed_batch=2,
                                                  return_stderr=True)
    values, stderr = batched([1, 2])
    ref = tm.integrate_importance_sampling(fns, target, proposal, n_samples=N,
                                           seed=2, return_stderr=True,
                                           device="cpu")
    np.testing.assert_array_equal(values[1].numpy(), ref.values)
    np.testing.assert_array_equal(stderr[1].numpy(), ref.stderr)


# -- what the handles refuse, as the JAX package refuses it ----------------------


def _normal(pkg):
    return pkg.Distribution.normal(0.0, 1.0)


ERRORS = {
    "seed-count": lambda pkg, i: i.compile_integrate(
        FNS, _normal(pkg), n_samples=N, seed_batch=3)([1, 2]),
    "param-seed-count": lambda pkg, i: i.compile_integrate(
        FNS, _normal(pkg), n_samples=N, seed_batch=2, param_batch=True)(
        [1], pkg.pack_param_batch([_normal(pkg)] * 2)),
    "params-shape": lambda pkg, i: i.compile_integrate(
        FNS, _normal(pkg), n_samples=N, seed_batch=2, param_batch=True)(
        [1, 2], np.zeros((2, 3), np.float32)),
    "params-count": lambda pkg, i: i.compile_integrate(
        FNS, _normal(pkg), n_samples=N, seed_batch=2, param_batch=True)([1, 2]),
    "other-family": lambda pkg, i: i.compile_integrate(
        FNS, _normal(pkg), n_samples=N, seed_batch=2, param_batch=True)(
        [1, 2], pkg.pack_param_batch([pkg.Distribution.uniform(0, 1)] * 2)),
    "custom-param-batch": lambda pkg, i: i.compile_integrate(
        FNS, pkg.Distribution.beta(2.0, 5.0), n_samples=N, param_batch=True),
    "method": lambda pkg, i: i.compile_integrate(FNS, _normal(pkg),
                                                 method="sobol"),
    "is-seed-count": lambda pkg, i: i.compile_importance_sampling(
        FNS, _normal(pkg), pkg.Distribution.normal(0.0, 2.0), n_samples=N,
        seed_batch=2)([1, 2, 3]),
    "no-functions": lambda pkg, i: i.compile_integrate([], _normal(pkg)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_handle_errors_match_jax(case):
    with pytest.raises(Exception) as want:
        ERRORS[case](jmc, _jax())
    with pytest.raises(type(want.value)) as got:
        ERRORS[case](tm, _port())
    assert str(got.value) == str(want.value)


def test_out_of_range_seeds_raise_as_in_jax():
    for seeds in ([-1, 2], [2**32, 1]):
        with pytest.raises(OverflowError):
            np.asarray(seeds, np.uint32)
        prog = _port().compile_integrate(FNS, _normal(tm), n_samples=N,
                                         seed_batch=2)
        with pytest.raises(OverflowError):
            prog(seeds)
    with pytest.raises(OverflowError):
        _port().compile_integrate(FNS, _normal(tm), n_samples=N)(2**32)
