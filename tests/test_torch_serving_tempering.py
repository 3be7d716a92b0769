"""The port's tempered ``compile_mcmc`` serving handle, with seed batches
on the tempered kernel's batch axis.

On the CPU a handle runs the plain PyTorch version rep by rep: each
element of a batched handle (values, cold acceptance, swap rate, error
bars) is its unbatched handle's, bit for bit, for R = 1, 2, 4 and 7, and
an unbatched handle gives ``integrate_mcmc``'s values, acceptance and
swap rate as float32.  The CUDA kernel's batch axis is held to the same
equalities in ``test_torch_cuda.py``, on both of its layouts.

Against the JAX package each rep is held, ladder for ladder, to
``jmc.MonteCarloIntegrator(backend="pallas")``'s handle in interpret mode
(warnings raised as errors, so a fall back to its XLA sweep fails) on the
same seeds, under the flushed subnormals of XLA's CPU backend, at the
tolerances of ``tests/test_torch_tempering.py``: the means within rel
1e-5 + abs 1e-6, the acceptance rates within 1e-7, the swap rates within
1e-6 and the error bars within rel 1e-3.  The JAX package's default
handle off the TPU batches its XLA sweep, keyed on ``jax.random``, with
``lax.map``: there the port agrees statistically, within 6 combined
standard errors.  Sizes: 1,024 chains (the kernel's least), tens of
steps.
"""

import contextlib
import math
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.mcmc_kernel import plan_chains, plan_mcmc_grid
from tpu_montecarlo_torch.ops.mcmc_pt_kernel import (
    mcmc_pt_batch,
    mcmc_pt_cuda,
    pt_batch_finish,
    pt_finish,
)

KW = dict(n_steps=24, n_chains=1024, n_burnin=6)
SEEDS = [7, 42, 2**32 - 5, 11, 12345, 3, 99]
LADDER4 = [1.0, 2.0, 4.0, 8.0]
FNS1 = [lambda x: x, lambda x: x * x]
FNS2 = [lambda x, y: x * y, lambda x, y: x * x + y * y]


def logmix(x):
    # 0.5 N(-4,1) + 0.5 N(4,1): E[X] = 0, E[X^2] = 17 (c12's target,
    # benchmarks/run_all.py:518-522).
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


def _c9e(x, y):
    # c9e's bivariate normal, rho = 0.8 (benchmarks/run_all.py:386-390).
    return -(x * x - 1.6 * x * y + y * y) / 0.72


def _beta_target(pkg):
    return [pkg.Distribution.beta(2.0, 5.0), pkg.Distribution.normal(0.0, 1.0)]


# id: (fns, target maker, proposal maker, temperatures): c12, c12b, c12c,
# c12d's shapes (benchmarks/run_all.py:508-585) cut to tens of steps, a
# fixed walk on c9e's joint target and a product of closed forms.
CASES = {
    "c12-adaptive-walk": (
        FNS1, lambda pkg: logmix,
        lambda pkg: pkg.RandomWalk(step_size=0.5, adapt=True,
                                   init_range=(3.0, 5.0)), LADDER4),
    "c12b-hmc": (
        FNS1, lambda pkg: logmix,
        lambda pkg: pkg.HMC(step_size=0.35, n_leapfrog=3,
                            init_range=(3.0, 5.0)), LADDER4),
    "c12c-independence": (
        FNS1, lambda pkg: logmix,
        lambda pkg: pkg.Distribution.normal(0.0, 6.0), LADDER4),
    "c12d-custom-product": (
        FNS2, _beta_target,
        lambda pkg: [pkg.Distribution.uniform(0.0, 1.0),
                     pkg.Distribution.normal(0.0, 2.0)], [1.0, 2.0, 4.0]),
    "walk-joint": (
        FNS2, lambda pkg: _c9e,
        lambda pkg: pkg.RandomWalk(step_size=1.0, init_range=(-4.0, 4.0)),
        [1.0, 2.0, 4.0, 8.0, 16.0]),
    "independence-product": (
        FNS2,
        lambda pkg: [pkg.Distribution.uniform(-1.0, 2.0),
                     pkg.Distribution.exponential(1.5)],
        lambda pkg: [pkg.Distribution.normal(0.5, 1.5),
                     pkg.Distribution.exponential(1.0)], [1.0, 2.5]),
}


def _port():
    return tm.MonteCarloIntegrator(device="cpu")


def _jax():
    return jmc.MonteCarloIntegrator(backend="pallas")


def _handle(pkg, integ, case, **kw):
    fns, target, proposal, temps = CASES[case]
    return integ.compile_mcmc(fns, target(pkg), proposal(pkg),
                              temperatures=temps, **kw)


@contextlib.contextmanager
def _flushing_subnormals():
    """Flush float32 subnormals to zero, as XLA's CPU backend does, on
    this thread, with torch's intra-op pool cut to this thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("stderr", [False, True], ids=["values", "stderr"])
@pytest.mark.parametrize("case", list(CASES))
def test_seed_batch_is_its_unbatched_calls(case, stderr):
    kw = dict(KW, return_stderr=stderr)
    seeds = SEEDS[:3]
    out = _handle(tm, _port(), case, seed_batch=3, **kw)(seeds)
    assert len(out) == 3 + stderr
    assert out[0].shape == (3, len(CASES[case][0]))
    assert out[1].shape == out[2].shape == (3,)
    single = _handle(tm, _port(), case, **kw)
    fns, target, proposal, temps = CASES[case]
    for r, seed in enumerate(seeds):
        one = single(seed)
        assert one[1].shape == one[2].shape == ()
        _equal([o[r] for o in out], one)
        ref = tm.integrate_mcmc(fns, target(tm), proposal(tm),
                                temperatures=temps, seed=seed,
                                return_stderr=stderr, device="cpu", **KW)
        np.testing.assert_array_equal(one[0].numpy(), ref.values)
        assert float(one[1]) == ref.acceptance_rate
        assert float(one[2]) == ref.diagnostics["swap_rate"]
        if stderr:
            np.testing.assert_array_equal(one[3].numpy(), ref.stderr)


@pytest.mark.parametrize("reps", [1, 2, 4, 7])
def test_every_batch_size(reps):
    """R = 1, 2, 4, 7 jobs in one call of the batch wrapper, with error
    bars: each rep's rows, final cold states and finish are its
    unbatched run's."""
    integ = _port()
    fns, target, proposal, temps = CASES["c12-adaptive-walk"]
    walk = proposal(tm)
    parsed = integ._parse_nd_mcmc_args(target(tm), walk)
    program, cfg, params, ladder = integ._pt_kernel_program(
        fns, walk, parsed, tuple(1.0 / t for t in temps), KW["n_steps"],
        KW["n_burnin"], True)
    grid = plan_mcmc_grid(plan_chains(KW["n_chains"], None))
    seeds = torch.from_numpy(
        np.asarray(SEEDS[:reps], np.uint32).view(np.int32))
    out = mcmc_pt_batch(program, cfg, params, ladder, seeds, grid)
    finished = pt_batch_finish(out, grid, cfg, len(fns))
    for r, seed in enumerate(SEEDS[:reps]):
        one = mcmc_pt_cuda(program, cfg, params, ladder, seed, grid)
        _equal([out.rows[r], out.x_final[r]], [one.rows, one.x_final])
        _equal([f[r] for f in finished], pt_finish(one, grid, cfg, len(fns)))


def _close_to_jax(got, want, stderr: bool):
    """One rep's (values, acceptance, swap rate[, stderr]) against the JAX
    handle's."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert abs(got[1] - want[1]) <= 1e-7
    assert abs(got[2] - want[2]) <= 1e-6
    if stderr:
        np.testing.assert_allclose(got[3], want[3], rtol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_seed_batch_matches_the_jax_handle(case):
    kw = dict(KW, return_stderr=True, seed_batch=2)
    with _flushing_subnormals():
        got = _handle(tm, _port(), case, **kw)(SEEDS[:2])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = _handle(jmc, _jax(), case, **kw)(SEEDS[:2])
    for r in range(2):
        _close_to_jax([g[r] for g in got], [w[r] for w in want], True)


def test_without_error_bars_the_handle_is_a_triple():
    with _flushing_subnormals():
        got = _handle(tm, _port(), "c12-adaptive-walk", **KW)(3)
    assert len(got) == 3 and got[0].shape == (2,)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = _handle(jmc, _jax(), "c12-adaptive-walk", **KW)(3)
    _close_to_jax(got, want, False)


def test_family_target_under_a_seed_batch():
    """An extended family as the tempered target (Laplace(3, 1) under
    c12's walk): each rep its unbatched call."""
    t = tm.Distribution.laplace(3.0, 1.0)
    walk = tm.RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0))
    kw = dict(KW, return_stderr=True, temperatures=LADDER4)
    out = _port().compile_mcmc(FNS1, t, walk, seed_batch=2, **kw)(SEEDS[:2])
    single = _port().compile_mcmc(FNS1, t, walk, **kw)
    for r, seed in enumerate(SEEDS[:2]):
        _equal([o[r] for o in out], single(seed))


def test_the_jax_default_handle_agrees_statistically():
    """The JAX package's default handle off the TPU runs its XLA
    tempering sweep under lax.map, keyed on jax.random: the port's reps
    agree within 6 combined standard errors."""
    kw = dict(n_steps=400, n_chains=1024, n_burnin=100, return_stderr=True,
              seed_batch=2)
    v, _, w, se = _handle(tm, _port(), "c12c-independence", **kw)([1, 2])
    jv, _, jw, jse = _handle(jmc, jmc.MonteCarloIntegrator(),
                             "c12c-independence", **kw)([1, 2])
    jv, jse = np.asarray(jv, np.float64), np.asarray(jse, np.float64)
    z = (v.double().numpy() - jv) / np.hypot(se.double().numpy(), jse)
    assert np.all(np.abs(z) < 6.0), z
    assert np.all((w.numpy() > 0.0) & (w.numpy() < 1.0))


def test_a_batch_is_one_kernel_call(monkeypatch):
    """A handle call reaches mcmc_pt_batch once with all its seeds (on the
    CPU the wrapper runs the plain version rep by rep and counts no
    launch)."""
    import tpu_montecarlo_torch.api.tempering as api_pt

    calls = []
    real = api_pt.mcmc_pt_batch

    def spy(*args, **kwargs):
        calls.append(tuple(args[4].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(api_pt, "mcmc_pt_batch", spy)
    before = mcmc_pt_cuda.launches
    _handle(tm, _port(), "c12-adaptive-walk", seed_batch=3, **KW)(SEEDS[:3])
    assert mcmc_pt_cuda.launches == before
    assert calls == [(3,)]


# -- what the handle refuses, as the JAX package refuses it --------------------


def _walk(pkg, **kw):
    return pkg.RandomWalk(step_size=0.5, init_range=(3.0, 5.0), **kw)


def _pt(pkg, i, temps=LADDER4, proposal=None, **kw):
    return i.compile_mcmc(FNS1, logmix, proposal or _walk(pkg),
                          temperatures=temps, **dict(KW, **kw))


ERRORS = {
    "param-batch": lambda pkg, i: _pt(pkg, i, param_batch=True),
    "one-rung": lambda pkg, i: _pt(pkg, i, temps=[1.0]),
    "not-from-one": lambda pkg, i: _pt(pkg, i, temps=[2.0, 4.0]),
    "not-increasing": lambda pkg, i: _pt(pkg, i, temps=[1.0, 4.0, 2.0]),
    "not-finite": lambda pkg, i: _pt(pkg, i, temps=[1.0, float("inf")]),
    "samples": lambda pkg, i: _pt(pkg, i, return_samples=2),
    "adaptive-without-burn-in": lambda pkg, i: _pt(
        pkg, i, proposal=_walk(pkg, adapt=True), n_burnin=0),
    "seed-count": lambda pkg, i: _pt(pkg, i, seed_batch=3)([1, 2]),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_refusals_match_jax(case):
    with pytest.raises(Exception) as want:
        ERRORS[case](jmc, _jax())
    with pytest.raises(type(want.value)) as got:
        ERRORS[case](tm, _port())
    assert str(got.value) == str(want.value)
