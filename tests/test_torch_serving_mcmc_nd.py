"""The port's nd ``compile_mcmc`` serving handle, with seed and param
batches on the nd MCMC kernel's batch axis.

On the CPU a handle runs the plain PyTorch version rep by rep: each
element of a batched handle (values, acceptance, error bars, draws) is
its unbatched handle's, bit for bit, for R = 1, 2, 4 and 7, and an
unbatched handle gives ``integrate_mcmc``'s values as float32.  The CUDA
kernel's batch axis is held to the same equalities in
``test_torch_cuda.py``.

Against the JAX package each rep is held, chain for chain, to
``jmc.MonteCarloIntegrator(backend="pallas")``'s handle in interpret mode
(warnings raised as errors, so a fall back to its XLA sweep fails) on the
same seeds and rows, at the tolerances of
``tests/test_torch_serving_mcmc.py``: at most 1 % of the draws more than
1e-4 (relative) apart, the means within 1e-5, the acceptance rates
within 1e-4 and the error bars within 1e-3 relative.  A decision that
lies within the libraries' last-bit differences of its threshold (logf,
expf, erfinv) flips, and the chain splits from there: where the draws
show split chains, the means may move by the split chains' share times
each integrand's range over the draws, the acceptance rates by that
share, and the error bars (the chain means' standard error) by the
range times the square root of the share over chains - 1.  The JAX package's
default handle off the TPU batches its XLA sweep, keyed on
``jax.random``, with ``lax.map``: there the port agrees statistically,
within 6 combined standard errors.  Sizes: 1,024 chains (the kernel's
least), tens of steps.
"""

import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    mcmc_batch_finish,
    mcmc_finish,
    plan_chains,
    plan_mcmc_grid,
)
from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_batch, mcmc_nd_cuda

KW = dict(n_steps=24, n_chains=1024, n_burnin=6)
SEEDS = [7, 42, 2**32 - 5, 11, 12345, 3, 99]
FNS = [lambda x, y: x * y, lambda x, y: x * x + y]
DRAWS = 4
SPLIT = 0.01


def _c9e(x, y):
    # c9e's bivariate normal, rho = 0.8 (benchmarks/run_all.py:386-390).
    return -(x * x - 1.6 * x * y + y * y) / 0.72


def _n(pkg, *a):
    return pkg.Distribution.normal(*a)


TARGETS = {
    "product": lambda pkg: [_n(pkg, 0.5, 1.5),
                            pkg.Distribution.exponential(1.5)],
    "joint": lambda pkg: _c9e,
}
PROPOSALS = {
    "independence": lambda pkg, t: (
        [_n(pkg, 0.0, 3.0), pkg.Distribution.exponential(1.0)]
        if t == "product" else [_n(pkg, 0.0, 2.0)] * 2),
    "walk": lambda pkg, t: pkg.RandomWalk(step_size=[1.0, 0.8],
                                          init_range=(-2.0, 3.0)),
    "adaptive-walk": lambda pkg, t: pkg.RandomWalk(
        adapt=True, target_accept=0.3, init_range=(-2.0, 3.0)),
    "hmc": lambda pkg, t: pkg.HMC(step_size=0.3, n_leapfrog=3,
                                  init_range=(-2.0, 3.0)),
}


def _port():
    return tm.MonteCarloIntegrator(device="cpu")


def _jax():
    return jmc.MonteCarloIntegrator(backend="pallas")


def _jax_call(make, *args):
    """The JAX handle's outputs; a warning (its fall back to the XLA sweep)
    raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return make()(*args)


def _handle(pkg, integ, target, proposal, **kw):
    return integ.compile_mcmc(FNS, TARGETS[target](pkg),
                              PROPOSALS[proposal](pkg, target), **kw)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w), (g, w)


def _close_to_jax(got, want, stderr: bool, draws: bool):
    """One rep's (values, acceptance[, stderr][, draws]) against the JAX
    handle's.  With draws, a chain any of whose draws is apart split.  A
    share s of N chains split moves each chain's mean by at most the
    integrand's range (over both runs' draws): the mean by s x range, the
    acceptance rate by s, and the error bar, the norm of the centred
    chain means over sqrt(N (N - 1)), by range x sqrt(s / (N - 1))."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    split, spread, chains = 0.0, 0.0, 2
    if draws:
        a, b = got[-1], want[-1]  # (m, chains, d)
        assert a.shape == b.shape
        apart = np.abs(a - b) > 1e-4 * np.maximum(1.0, np.abs(b))
        assert apart.mean() <= SPLIT, apart.mean()
        split, chains = apart.any(axis=(0, 2)).mean(), a.shape[1]
        xs = np.moveaxis(np.concatenate([a, b]), -1, 0)
        spread = np.array([np.ptp(f(*xs)) for f in FNS])
    gap = np.abs(got[0] - want[0])
    assert np.all(gap <= 1e-5 + split * spread), (gap, split, spread)
    assert np.all(np.abs(got[1] - want[1]) <= 1e-4 + split)
    if stderr:
        gap = np.abs(got[2] - want[2])
        assert np.all(gap <= 1e-3 * np.abs(want[2])
                      + spread * np.sqrt(split / (chains - 1))), gap


CASES = [(p, t, s) for p in PROPOSALS for t in TARGETS for s in (False, True)]
IDS = [f"{p}-{t}{'-stderr' if s else ''}" for p, t, s in CASES]


@pytest.mark.parametrize("proposal,target,stderr", CASES, ids=IDS)
def test_seed_batch_is_its_unbatched_calls(proposal, target, stderr):
    kw = dict(KW, return_stderr=stderr, return_samples=DRAWS)
    seeds = SEEDS[:3]
    out = _handle(tm, _port(), target, proposal, seed_batch=3, **kw)(seeds)
    assert out[0].shape == (3, len(FNS)) and out[1].shape == (3,)
    assert out[-1].shape == (3, DRAWS, 1024, 2)
    single = _handle(tm, _port(), target, proposal, **kw)
    for r, seed in enumerate(seeds):
        one = single(seed)
        assert one[0].shape == (len(FNS),) and one[1].shape == ()
        assert one[-1].shape == (DRAWS, 1024, 2)
        _equal([o[r] for o in out], one)
        ref = tm.integrate_mcmc(FNS, TARGETS[target](tm),
                                PROPOSALS[proposal](tm, target), seed=seed,
                                return_stderr=stderr, return_samples=DRAWS,
                                device="cpu", **KW)
        np.testing.assert_array_equal(one[0].numpy(), ref.values)
        assert float(one[1]) == ref.acceptance_rate
        np.testing.assert_array_equal(one[-1].numpy(), ref.samples)
        if stderr:
            np.testing.assert_array_equal(one[2].numpy(), ref.stderr)


@pytest.mark.parametrize("reps", [1, 2, 4, 7])
def test_every_batch_size(reps):
    """R = 1, 2, 4, 7 jobs in one call of the batch wrapper, with error
    bars and draws: each rep's rows, final states, draws and finish are
    its unbatched run's."""
    integ = _port()
    walk = PROPOSALS["adaptive-walk"](tm, "joint")
    parsed = integ._parse_nd_mcmc_args(_c9e, walk)
    program, cfg, params = integ._nd_mcmc_kernel_program(
        FNS, walk, parsed, KW["n_steps"], KW["n_burnin"], True,
        samples=DRAWS)
    grid = plan_mcmc_grid(plan_chains(KW["n_chains"], None))
    seeds = torch.from_numpy(
        np.asarray(SEEDS[:reps], np.uint32).view(np.int32))
    out = mcmc_nd_batch(program, cfg, params, seeds, grid)
    finished = mcmc_batch_finish(out, grid, cfg, len(FNS))
    for r, seed in enumerate(SEEDS[:reps]):
        one = mcmc_nd_cuda(program, cfg, params, seed, grid)
        _equal([out.rows[r], out.x_final[r], out.samples[r]],
               [one.rows, one.x_final, one.samples])
        _equal([f[r] for f in finished], mcmc_finish(one, grid, cfg, len(FNS)))


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("proposal", list(PROPOSALS))
def test_seed_batch_matches_the_jax_handle(proposal, target):
    kw = dict(KW, return_stderr=True, return_samples=DRAWS, seed_batch=2)
    got = _handle(tm, _port(), target, proposal, **kw)(SEEDS[:2])
    want = _jax_call(lambda: _handle(jmc, _jax(), target, proposal, **kw),
                     SEEDS[:2])
    for r in range(2):
        _close_to_jax([g[r] for g in got], [w[r] for w in want], True, True)


def test_without_outputs_the_handle_is_values_and_acceptance():
    prog = _handle(tm, _port(), "joint", "walk", **KW)
    values, acceptance = prog(3)
    assert values.shape == (len(FNS),) and acceptance.shape == ()
    want = _jax_call(lambda: _handle(jmc, _jax(), "joint", "walk", **KW), 3)
    _close_to_jax([values, acceptance], want, False, False)


ROW_TARGETS = [[(0.0, 1.0), (1.0, 2.0)], [(2.0, 0.5), (0.0, 1.0)],
               [(-1.0, 3.0), (0.5, 0.5)], [(0.5, 1.5), (-0.5, 1.0)]]


def _row_targets(pkg):
    return [[_n(pkg, *p) for p in row] for row in ROW_TARGETS]


def _row_proposals(pkg, kind):
    if kind == "independence":
        return [[_n(pkg, m, 3.0), _n(pkg, -m, 2.0)]
                for m in (0.0, 1.0, -1.0, 0.5)]
    if kind == "adaptive-walk":
        return [pkg.RandomWalk(step_size=[s, 1.0], adapt=True,
                               target_accept=a)
                for s, a in ((0.5, 0.3), (1.0, 0.44), (2.0, 0.5), (0.7, 0.6))]
    if kind == "walk":
        return [pkg.RandomWalk(step_size=[s, 0.5]) for s in (0.5, 1.0, 2.0, 3.0)]
    return [pkg.HMC(step_size=s, n_leapfrog=3) for s in (0.2, 0.3, 0.4, 0.5)]


def _pack(pkg, kind, rows, targets):
    if kind == "independence":
        return pkg.pack_param_batch_nd(rows)
    return pkg.pack_random_walk_batch_nd(rows, targets)


@pytest.mark.parametrize("stderr", [False, True], ids=["values", "stderr"])
@pytest.mark.parametrize("kind", ["independence", "walk", "adaptive-walk",
                                  "hmc"])
def test_param_batch_rows(kind, stderr):
    """Four product targets of two normal dimensions under four proposal
    rows (pack_param_batch_nd, or pack_random_walk_batch_nd walks): each
    rep the unbatched handle with its target and proposal, and the JAX
    handle's chain for chain."""
    kw = dict(KW, return_stderr=stderr)
    targets, rows = _row_targets(tm), _row_proposals(tm, kind)
    prog = _port().compile_mcmc(FNS, targets[0], rows[0], seed_batch=4,
                                param_batch=True, **kw)
    seeds = SEEDS[:4]
    out = prog(seeds, tm.pack_param_batch_nd(targets),
               _pack(tm, kind, rows, targets))
    assert out[0].shape == (4, len(FNS)) and out[1].shape == (4,)
    for r, seed in enumerate(seeds):
        one = _port().compile_mcmc(FNS, targets[r], rows[r], **kw)(seed)
        _equal([o[r] for o in out], one)
    jt, jr = _row_targets(jmc), _row_proposals(jmc, kind)
    want = _jax_call(
        lambda: _jax().compile_mcmc(FNS, jt[0], jr[0], seed_batch=4,
                                    param_batch=True, **kw),
        seeds, jmc.pack_param_batch_nd(jt), _pack(jmc, kind, jr, jt))
    for r in range(4):
        _close_to_jax([g[r] for g in out], [w[r] for w in want], stderr,
                      False)


def test_param_batch_of_one_keeps_the_batch_axis():
    t, q = _row_targets(tm)[:1], _row_proposals(tm, "independence")[:1]
    prog = _port().compile_mcmc(FNS, t[0], q[0], param_batch=True, **KW)
    values, acceptance = prog([5], tm.pack_param_batch_nd(t),
                              tm.pack_param_batch_nd(q))
    assert values.shape == (1, len(FNS)) and acceptance.shape == (1,)
    _equal([values[0], acceptance[0]],
           _port().compile_mcmc(FNS, t[0], q[0], **KW)(5))


def test_custom_dimension_under_a_seed_batch():
    """A Beta(2, 5) target dimension (its log table) and a sampler-mode
    Beta proposal dimension: each rep its unbatched call, and the JAX
    kernel's handle chain for chain."""
    def dims(pkg):
        b = pkg.Distribution.beta(2.0, 5.0)
        return [b, _n(pkg, 0.0, 1.0)], [b, _n(pkg, 0.0, 2.0)]

    kw = dict(KW, return_stderr=True, return_samples=DRAWS)
    t, q = dims(tm)
    out = _port().compile_mcmc(FNS, t, q, seed_batch=2, **kw)(SEEDS[:2])
    single = _port().compile_mcmc(FNS, t, q, **kw)
    for r, seed in enumerate(SEEDS[:2]):
        _equal([o[r] for o in out], single(seed))
    jt, jq = dims(jmc)
    want = _jax_call(lambda: _jax().compile_mcmc(FNS, jt, jq, seed_batch=2,
                                                 **kw), SEEDS[:2])
    for r in range(2):
        _close_to_jax([g[r] for g in out], [w[r] for w in want], True, True)


def test_family_dimensions_take_seed_and_param_batches():
    """The extended families as dimensions: a seed batch over a Cauchy x
    Weibull target, and a param batch of Laplace x Weibull rows, each rep
    its unbatched call."""
    d = tm.Distribution
    t, q = [d.cauchy(0.0, 1.0), d.weibull(1.5, 2.0)], [_n(tm, 0.0, 3.0)] * 2
    kw = dict(KW, return_stderr=True)
    out = _port().compile_mcmc(FNS, t, q, seed_batch=2, **kw)(SEEDS[:2])
    single = _port().compile_mcmc(FNS, t, q, **kw)
    for r, seed in enumerate(SEEDS[:2]):
        _equal([o[r] for o in out], single(seed))
    rows = [[d.laplace(m, 1.0), d.weibull(1.5, 2.0 + m)] for m in (0.0, 1.0)]
    walks = [tm.RandomWalk(step_size=[s, 1.0], init_range=(0.5, 2.0))
             for s in (0.5, 1.0)]
    prog = _port().compile_mcmc(FNS, rows[0], walks[0], seed_batch=2,
                                param_batch=True, **kw)
    out = prog(SEEDS[:2], tm.pack_param_batch_nd(rows),
               tm.pack_random_walk_batch_nd(walks, rows))
    for r, seed in enumerate(SEEDS[:2]):
        _equal([o[r] for o in out],
               _port().compile_mcmc(FNS, rows[r], walks[r], **kw)(seed))


def test_the_jax_default_handle_agrees_statistically():
    """The JAX package's default handle off the TPU runs its XLA sweep
    under lax.map, keyed on jax.random: the port's reps agree within 6
    combined standard errors."""
    kw = dict(n_steps=400, n_chains=1024, n_burnin=100, return_stderr=True,
              seed_batch=2)
    v, _, se = _handle(tm, _port(), "joint", "independence", **kw)([1, 2])
    jv, _, jse = _handle(jmc, jmc.MonteCarloIntegrator(), "joint",
                         "independence", **kw)([1, 2])
    jv, jse = np.asarray(jv, np.float64), np.asarray(jse, np.float64)
    z = (v.double().numpy() - jv) / np.hypot(se.double().numpy(), jse)
    assert np.all(np.abs(z) < 6.0), z


def test_one_dimension_is_the_1d_handle():
    """d == 1 under a product target delegates to the 1-D handle
    (tpu_montecarlo/api/mcmc_nd.py:727-735)."""
    f1 = [lambda x: x * x]
    t, q = _n(tm, 0.5, 1.5), _n(tm, 0.0, 3.0)
    kw = dict(KW, return_stderr=True, return_samples=DRAWS, seed_batch=2)
    got = _port().compile_mcmc(f1, [t], [q], **kw)(SEEDS[:2])
    want = _port().compile_mcmc(f1, t, q, **kw)(SEEDS[:2])
    _equal(got, want)
    assert got[-1].shape == (2, DRAWS, 1024)


def test_a_batch_is_one_kernel_call(monkeypatch):
    """A handle call reaches mcmc_nd_batch once with all its seeds (on the
    CPU the wrapper runs the plain version rep by rep and counts no
    launch)."""
    import tpu_montecarlo_torch.api.mcmc_nd as api_nd

    calls = []
    real = api_nd.mcmc_nd_batch

    def spy(*args, **kwargs):
        calls.append(tuple(args[3].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(api_nd, "mcmc_nd_batch", spy)
    before = mcmc_nd_cuda.launches
    _handle(tm, _port(), "joint", "walk", seed_batch=3, **KW)(SEEDS[:3])
    assert mcmc_nd_cuda.launches == before
    assert calls == [(3,)]


# -- what the handle refuses, as the JAX package refuses it --------------------


def _pt2(pkg):
    return [_n(pkg, 0, 1), _n(pkg, 0, 2)]


def _rw_pack(pkg, adapt=False):
    return pkg.pack_random_walk_batch_nd([pkg.RandomWalk(adapt=adapt)] * 2,
                                         _pt2(pkg))


def _param_prog(pkg, i, proposal):
    return i.compile_mcmc(FNS, _pt2(pkg), proposal, seed_batch=2,
                          param_batch=True, **KW)


ERRORS = {
    "param-batch-joint": lambda pkg, i: i.compile_mcmc(
        FNS, _c9e, [_n(pkg, 0, 2)] * 2, param_batch=True, **KW),
    "adaptive-without-burn-in": lambda pkg, i: i.compile_mcmc(
        FNS, _c9e, pkg.RandomWalk(adapt=True, init_range=(-1.0, 1.0)),
        n_steps=10, n_burnin=0),
    "custom-target-param-batch": lambda pkg, i: i.compile_mcmc(
        FNS, [pkg.Distribution.beta(2.0, 5.0), _n(pkg, 0, 1)], _pt2(pkg),
        param_batch=True, **KW),
    "custom-proposal-param-batch": lambda pkg, i: i.compile_mcmc(
        FNS, _pt2(pkg), [pkg.Distribution.beta(2.0, 5.0), _n(pkg, 0, 1)],
        param_batch=True, **KW),
    "custom-walk-target-param-batch": lambda pkg, i: i.compile_mcmc(
        FNS, [pkg.Distribution.beta(2.0, 5.0), _n(pkg, 0, 1)],
        pkg.RandomWalk(), param_batch=True, **KW),
    "samples-with-param-batch": lambda pkg, i: i.compile_mcmc(
        FNS, _pt2(pkg), _pt2(pkg), param_batch=True, return_samples=2, **KW),
    "samples-past-steps": lambda pkg, i: i.compile_mcmc(
        FNS, _pt2(pkg), _pt2(pkg), return_samples=25, **KW),
    "dimension-mismatch": lambda pkg, i: i.compile_mcmc(
        FNS, [_n(pkg, 0, 1)] * 3, _pt2(pkg), **KW),
    "seed-count": lambda pkg, i: i.compile_mcmc(
        FNS, _pt2(pkg), _pt2(pkg), seed_batch=3, **KW)([1, 2]),
    "target-families": lambda pkg, i: _param_prog(pkg, i, _pt2(pkg))(
        [1, 2], pkg.pack_param_batch_nd(
            [[pkg.Distribution.uniform(0, 1), _n(pkg, 0, 1)]] * 2),
        pkg.pack_param_batch_nd([_pt2(pkg)] * 2)),
    "proposal-shape": lambda pkg, i: _param_prog(pkg, i, _pt2(pkg))(
        [1, 2], pkg.pack_param_batch_nd([_pt2(pkg)] * 2),
        np.zeros((2, 2, 3), np.float32)),
    "walk-pack-in-a-density-slot": lambda pkg, i: _param_prog(
        pkg, i, _pt2(pkg))([1, 2], pkg.pack_param_batch_nd([_pt2(pkg)] * 2),
                           _rw_pack(pkg)),
    "fixed-pack-for-an-adaptive-walk": lambda pkg, i: _param_prog(
        pkg, i, pkg.RandomWalk(adapt=True))(
        [1, 2], pkg.pack_param_batch_nd([_pt2(pkg)] * 2), _rw_pack(pkg)),
    "walk-width": lambda pkg, i: _param_prog(pkg, i, pkg.RandomWalk())(
        [1, 2], pkg.pack_param_batch_nd([_pt2(pkg)] * 2),
        np.zeros((2, 2, 2), np.float32)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_refusals_match_jax(case):
    with pytest.raises(Exception) as want:
        ERRORS[case](jmc, _jax())
    with pytest.raises(type(want.value)) as got:
        ERRORS[case](tm, _port())
    assert str(got.value) == str(want.value)
