"""The port's nd serving handles: ``compile_integrate`` over a sequence of
Distributions and ``compile_importance_sampling`` over sequences, with
seed and param batches on the nd kernel's batch axis.

On the CPU a handle runs the plain PyTorch version rep by rep: each
element of a batched handle is its unbatched handle's result, bit for
bit, and an unbatched handle gives ``integrate()``'s values as float32.
rQMC with error bars runs its rotations as one batched launch, bit for
bit the per-rotation calls it replaced.  The CUDA kernel's batch axis is
held to the same equalities in ``test_torch_cuda.py``.

Against the JAX package: the nd handle is held to
``jmc.MonteCarloIntegrator(backend="pallas")``'s nd handle in interpret
mode on the same seeds and rows, means within 1e-6 + 1e-6 |mean| and
error bars within 1e-4 relative (``tests/test_torch_nd.py``); the JAX
package has no nd importance handle, so the port's is held to its
``integrate_importance_sampling`` per seed within the same.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm

N = 1 << 16
SEEDS = [7, 42, 2**32 - 5]
MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
STDERR_TOL = dict(rtol=1e-4, atol=1e-9)
# c9's set (BASELINE.md config 9): N(0,1) x U(0,1) x Exp(2).
C9_FNS = [lambda x, y, z: x * y * z, lambda x, y, z: x * x + y + z]


def _c9(pkg):
    return [pkg.Distribution.normal(0.0, 1.0), pkg.Distribution.uniform(0.0, 1.0),
            pkg.Distribution.exponential(2.0)]


def _port():
    return tm.MonteCarloIntegrator(device="cpu")


def _jax():
    return jmc.MonteCarloIntegrator(backend="pallas")


def _np(out):
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


def _close_to(got, want, stderr: bool):
    if stderr:
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), **MEAN_TOL)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), **STDERR_TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **MEAN_TOL)


MODES = [("mc", False), ("mc", True), ("antithetic", False),
         ("antithetic", True), ("qmc", False)]
IDS = [f"{m}{'-stderr' if s else ''}" for m, s in MODES]


@pytest.mark.parametrize("method,stderr", MODES, ids=IDS)
def test_seed_batch_is_its_unbatched_calls_and_the_jax_handle(method, stderr):
    kw = dict(n_samples=N, method=method, return_stderr=stderr)
    batched = _port().compile_integrate(C9_FNS, _c9(tm), seed_batch=3, **kw)
    single = _port().compile_integrate(C9_FNS, _c9(tm), **kw)
    out = batched(SEEDS)
    for r, seed in enumerate(SEEDS):
        one = single(seed)
        _equal(tuple(o[r] for o in out) if stderr else out[r], one)
        ref = tm.integrate(C9_FNS, _c9(tm), n_samples=N, seed=seed,
                           method=method, return_stderr=stderr, device="cpu")
        np.testing.assert_array_equal((one[0] if stderr else one).numpy(),
                                      ref.values)
    want = _jax().compile_integrate(C9_FNS, _c9(jmc), seed_batch=3, **kw)(SEEDS)
    _close_to(out, want, stderr)


ND_ROWS = {
    "c9": lambda pkg: [
        [pkg.Distribution.normal(0.0, 1.0), pkg.Distribution.uniform(0.0, 1.0),
         pkg.Distribution.exponential(2.0)],
        [pkg.Distribution.normal(1.0, 0.5), pkg.Distribution.uniform(-1.0, 1.0),
         pkg.Distribution.exponential(0.5)],
    ],
    "families": lambda pkg: [
        [pkg.Distribution.gumbel(1.0, 0.5), pkg.Distribution.laplace(3.0, 1.0),
         pkg.Distribution.weibull(1.5, 2.0)],
        [pkg.Distribution.gumbel(-2.0, 3.0), pkg.Distribution.laplace(0.0, 0.3),
         pkg.Distribution.weibull(0.5, 1.0)],
    ],
}


@pytest.mark.parametrize("stderr", [False, True], ids=["values", "stderr"])
@pytest.mark.parametrize("rows", list(ND_ROWS))
def test_param_batch_rows(rows, stderr):
    """Each (d, 2) row of a pack_param_batch_nd batch is the unbatched
    handle over its Distributions; the batch is the JAX handle's."""
    kw = dict(n_samples=N, return_stderr=stderr)
    dists = ND_ROWS[rows](tm)
    prog = _port().compile_integrate(C9_FNS, dists[0], seed_batch=2,
                                     param_batch=True, **kw)
    out = prog(SEEDS[:2], tm.pack_param_batch_nd(dists))
    for r, (seed, row) in enumerate(zip(SEEDS, dists)):
        one = _port().compile_integrate(C9_FNS, row, **kw)(seed)
        _equal(tuple(o[r] for o in out) if stderr else out[r], one)
    jdists = ND_ROWS[rows](jmc)
    want = _jax().compile_integrate(C9_FNS, jdists[0], seed_batch=2,
                                    param_batch=True, **kw)(
        SEEDS[:2], jmc.pack_param_batch_nd(jdists))
    _close_to(out, want, stderr)


@pytest.mark.parametrize("batch", ["seeds", "params"])
def test_qmc_handle_takes_in_kernel_error_bars(batch):
    """method="qmc" with return_stderr over c9's dimensions: the kernel's
    pilot-shifted squares under the Sobol net, as the JAX nd handle gives
    them; each element is its unbatched handle's, bit for bit."""
    kw = dict(n_samples=N, method="qmc", return_stderr=True, seed_batch=2)
    rows = ND_ROWS["c9"](tm)
    if batch == "params":
        out = _port().compile_integrate(C9_FNS, rows[0], param_batch=True,
                                        **kw)(SEEDS[:2],
                                              tm.pack_param_batch_nd(rows))
    else:
        out = _port().compile_integrate(C9_FNS, rows[0], **kw)(SEEDS[:2])
    for r, seed in enumerate(SEEDS[:2]):
        row = rows[r] if batch == "params" else rows[0]
        one = _port().compile_integrate(C9_FNS, row, n_samples=N,
                                        method="qmc",
                                        return_stderr=True)(seed)
        _equal((out[0][r], out[1][r]), one)
    jrows = ND_ROWS["c9"](jmc)
    if batch == "params":
        want = _jax().compile_integrate(C9_FNS, jrows[0], param_batch=True,
                                        **kw)(SEEDS[:2],
                                              jmc.pack_param_batch_nd(jrows))
    else:
        want = _jax().compile_integrate(C9_FNS, jrows[0], **kw)(SEEDS[:2])
    _close_to(out, want, True)


@pytest.mark.parametrize("method", ["mc", "antithetic", "qmc"])
def test_custom_dimensions_under_a_seed_batch(method):
    def dims(pkg):
        return [pkg.Distribution.beta(2.0, 5.0), pkg.Distribution.uniform(0.0, 1.0)]

    fns = [lambda x, y: x * y, lambda x, y: x * x]
    kw = dict(n_samples=N, method=method)
    out = _port().compile_integrate(fns, dims(tm), seed_batch=3, **kw)(SEEDS)
    single = _port().compile_integrate(fns, dims(tm), **kw)
    for r, seed in enumerate(SEEDS):
        _equal(out[r], single(seed))
    want = _jax().compile_integrate(fns, dims(jmc), seed_batch=3, **kw)(SEEDS)
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-5, atol=1e-5)


def test_rqmc_is_one_batched_launch_of_the_rotations():
    u = tm.Distribution.uniform(0.0, 1.0)
    fns = [lambda x, y: np.exp(x) * np.exp(y)]
    r, n, seed = 8, 1 << 18, 3
    got = tm.integrate(fns, [u, u], n_samples=n, seed=seed, method="qmc",
                       return_stderr=True, qmc_rotations=r, device="cpu")
    words = np.uint32(seed) + np.uint32(0x9E3779B9) * np.arange(r, dtype=np.uint32)
    single = _port().compile_integrate(fns, [u, u], n_samples=-(-n // r),
                                       method="qmc")
    vals = np.stack([single(int(w)).numpy() for w in words]).astype(np.float64)
    np.testing.assert_array_equal(got.values, vals.mean(axis=0))
    np.testing.assert_array_equal(got.stderr, vals.std(axis=0, ddof=1) / np.sqrt(r))
    batched = _port().compile_integrate(fns, [u, u], n_samples=-(-n // r),
                                        method="qmc", seed_batch=r)
    np.testing.assert_array_equal(batched(words).numpy(), vals)


IS_SETS = {
    "rare-event": lambda pkg: (
        [lambda x, y: (x > 2.0) * (y > 2.0)],
        [pkg.Distribution.normal(0.0, 1.0)] * 2,
        [pkg.Distribution.normal(2.5, 1.5)] * 2),
    "sampler-q": lambda pkg: (
        [lambda x, y: x * y],
        [pkg.Distribution.uniform(0.0, 1.0), pkg.Distribution.normal(0.0, 1.0)],
        [pkg.Distribution.beta(2.0, 2.0), pkg.Distribution.normal(0.0, 2.0)]),
}


@pytest.mark.parametrize("method,stderr", MODES, ids=IDS)
@pytest.mark.parametrize("case", list(IS_SETS))
def test_nd_importance_handle(case, method, stderr):
    fns, targets, proposals = IS_SETS[case](tm)
    kw = dict(n_samples=N, method=method, return_stderr=stderr)
    batched = _port().compile_importance_sampling(fns, targets, proposals,
                                                  seed_batch=3, **kw)
    single = _port().compile_importance_sampling(fns, targets, proposals, **kw)
    out = batched(SEEDS)
    jfns, jt, jq = IS_SETS[case](jmc)
    for r, seed in enumerate(SEEDS):
        one = single(seed)
        _equal(tuple(o[r] for o in out) if stderr else out[r], one)
        ref = tm.integrate_importance_sampling(
            fns, targets, proposals, n_samples=N, seed=seed, method=method,
            return_stderr=stderr, device="cpu")
        np.testing.assert_array_equal((one[0] if stderr else one).numpy(),
                                      ref.values)
    want = jmc.MonteCarloIntegrator(backend="pallas").integrate_importance_sampling(
        jfns, jt, jq, n_samples=N, seed=SEEDS[1], method=method,
        return_stderr=stderr)
    got = tuple(o[1] for o in out) if stderr else out[1]
    _close_to(got, (want.values, want.stderr) if stderr else want.values,
              stderr)


def _nd_handle(pkg, i, **kw):
    return i.compile_integrate(C9_FNS, _c9(pkg), n_samples=N, **kw)


ERRORS = {
    "seed-count": lambda pkg, i: _nd_handle(pkg, i, seed_batch=3)([1, 2]),
    "param-seed-count": lambda pkg, i: _nd_handle(
        pkg, i, seed_batch=2, param_batch=True)([1], pkg.pack_param_batch_nd(
            [_c9(pkg)] * 2)),
    "param-shape": lambda pkg, i: _nd_handle(
        pkg, i, seed_batch=2, param_batch=True)(
        [1, 2], np.zeros((2, 2, 2), np.float32)),
    "param-families": lambda pkg, i: _nd_handle(
        pkg, i, seed_batch=2, param_batch=True)(
        [1, 2], pkg.pack_param_batch_nd([_c9(pkg)[::-1]] * 2)),
    "custom-param-batch": lambda pkg, i: i.compile_integrate(
        [lambda x, y: x], [pkg.Distribution.beta(2.0, 5.0),
                           pkg.Distribution.uniform(0, 1)], param_batch=True),
    "bad-sequence": lambda pkg, i: i.compile_integrate(
        [lambda x, y: x], [pkg.Distribution.normal(0, 1), 3.0]),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_nd_handle_errors_match_jax(case):
    with pytest.raises(Exception) as want:
        ERRORS[case](jmc, _jax())
    with pytest.raises(type(want.value)) as got:
        ERRORS[case](tm, _port())
    if case != "bad-sequence":
        assert str(got.value) == str(want.value)
