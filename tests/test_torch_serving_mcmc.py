"""The port's 1-D ``compile_mcmc`` serving handle, with seed and param
batches on the 1-D MCMC kernel's batch axis.

On the CPU a handle runs the plain PyTorch version rep by rep: each
element of a batched handle (values, acceptance, error bars, draws) is
its unbatched handle's, bit for bit, and an unbatched handle gives
``integrate_mcmc``'s values as float32.  The CUDA kernel's batch axis is
held to the same equalities in ``test_torch_cuda.py``.

Against the JAX package each rep is held, chain for chain, to
``jmc.MonteCarloIntegrator(backend="pallas")``'s handle in interpret mode
on the same seeds and rows, at the tolerances of
``tests/test_torch_mcmc.py`` and ``tests/test_torch_hmc.py``: at most 1 %
of the draws more than 1e-4 (relative) apart, the means within 1e-5, the
acceptance rates within 1e-4 and the error bars within 1e-3 relative.
Sizes: 1,024 chains (the kernel's least), tens of steps.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm

KW = dict(n_steps=24, n_chains=1024, n_burnin=6)
SEEDS = [7, 42, 2**32 - 5]
FNS = [lambda x: x, lambda x: x * x]
DRAWS = 4
SPLIT = 0.01

PROPOSALS = {
    "independence": lambda pkg: pkg.Distribution.normal(0.0, 3.0),
    "walk": lambda pkg: pkg.RandomWalk(step_size=1.0),
    "adaptive-walk": lambda pkg: pkg.RandomWalk(adapt=True),
    "hmc": lambda pkg: pkg.HMC(step_size=0.4, n_leapfrog=3,
                               init_range=(-2.0, 3.0)),
}


def _target(pkg):
    return pkg.Distribution.normal(0.5, 1.5)


def _port():
    return tm.MonteCarloIntegrator(device="cpu")


def _jax():
    return jmc.MonteCarloIntegrator(backend="pallas")


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w), (g, w)


def _close_to_jax(got, want, stderr: bool, draws: bool):
    """One rep's (values, acceptance[, stderr][, draws]) against the JAX
    handle's."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert np.all(np.abs(got[1] - want[1]) <= 1e-4)
    if stderr:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-3)
    if draws:
        a, b = got[-1], want[-1]
        assert a.shape == b.shape
        apart = np.abs(a - b) > 1e-4 * np.maximum(1.0, np.abs(b))
        assert apart.mean() <= SPLIT, apart.mean()


CASES = [(p, s) for p in PROPOSALS for s in (False, True)]
IDS = [f"{p}{'-stderr' if s else ''}" for p, s in CASES]


@pytest.mark.parametrize("proposal,stderr", CASES, ids=IDS)
def test_seed_batch_is_its_unbatched_calls(proposal, stderr):
    kw = dict(KW, return_stderr=stderr, return_samples=DRAWS)
    batched = _port().compile_mcmc(FNS, _target(tm), PROPOSALS[proposal](tm),
                                   seed_batch=3, **kw)
    single = _port().compile_mcmc(FNS, _target(tm), PROPOSALS[proposal](tm),
                                  **kw)
    out = batched(SEEDS)
    assert out[0].shape == (3, len(FNS)) and out[1].shape == (3,)
    assert out[-1].shape == (3, DRAWS, 1024)
    for r, seed in enumerate(SEEDS):
        one = single(seed)
        assert one[0].shape == (len(FNS),) and one[1].shape == ()
        assert one[-1].shape == (DRAWS, 1024)
        _equal([o[r] for o in out], one)
        ref = tm.integrate_mcmc(FNS, _target(tm), PROPOSALS[proposal](tm),
                                seed=seed, return_stderr=stderr,
                                return_samples=DRAWS, device="cpu", **KW)
        np.testing.assert_array_equal(one[0].numpy(), ref.values)
        assert float(one[1]) == ref.acceptance_rate
        np.testing.assert_array_equal(one[-1].numpy(), ref.samples)
        if stderr:
            np.testing.assert_array_equal(one[2].numpy(), ref.stderr)


@pytest.mark.parametrize("proposal", list(PROPOSALS))
def test_seed_batch_matches_the_jax_handle(proposal):
    kw = dict(KW, return_stderr=True, return_samples=DRAWS, seed_batch=2)
    got = _port().compile_mcmc(FNS, _target(tm), PROPOSALS[proposal](tm),
                               **kw)(SEEDS[:2])
    want = _jax().compile_mcmc(FNS, _target(jmc), PROPOSALS[proposal](jmc),
                               **kw)(SEEDS[:2])
    for r in range(2):
        _close_to_jax([g[r] for g in got], [w[r] for w in want], True, True)


def test_without_outputs_the_handle_is_values_and_acceptance():
    prog = _port().compile_mcmc(FNS, _target(tm), PROPOSALS["walk"](tm), **KW)
    values, acceptance = prog(3)
    assert values.shape == (len(FNS),) and acceptance.shape == ()
    jv, ja = _jax().compile_mcmc(FNS, _target(jmc), PROPOSALS["walk"](jmc),
                                 **KW)(3)
    _close_to_jax([values, acceptance], [jv, ja], False, False)


TARGET_ROWS = [(0.0, 1.0), (2.0, 0.5), (-1.0, 3.0), (0.5, 1.5)]


def _targets(pkg):
    return [pkg.Distribution.normal(*p) for p in TARGET_ROWS]


def _walk_rows(pkg, kind):
    if kind == "independence":
        return [pkg.Distribution.normal(m, 3.0) for m in (0.0, 1.0, -1.0, 0.5)]
    if kind == "adaptive-walk":
        return [pkg.RandomWalk(step_size=s, adapt=True, target_accept=a)
                for s, a in ((0.5, 0.3), (1.0, 0.44), (2.0, 0.5), (0.7, 0.6))]
    if kind == "walk":
        return [pkg.RandomWalk(step_size=s) for s in (0.5, 1.0, 2.0, 3.0)]
    return [pkg.HMC(step_size=s, n_leapfrog=3) for s in (0.2, 0.3, 0.4, 0.5)]


def _pack(pkg, kind, rows, targets):
    if kind == "independence":
        return pkg.pack_param_batch(rows)
    return pkg.pack_random_walk_batch(rows, targets)


@pytest.mark.parametrize("stderr", [False, True], ids=["values", "stderr"])
@pytest.mark.parametrize("kind", ["independence", "walk", "adaptive-walk", "hmc"])
def test_param_batch_rows(kind, stderr):
    """Four normal targets under four proposal rows (pack_param_batch, or
    pack_random_walk_batch walks): each rep the unbatched handle with its
    target and proposal, and the JAX handle's chain for chain."""
    kw = dict(KW, return_stderr=stderr, return_samples=DRAWS)
    targets, rows = _targets(tm), _walk_rows(tm, kind)
    prog = _port().compile_mcmc(FNS, targets[0], rows[0], seed_batch=4,
                                param_batch=True, **kw)
    seeds = SEEDS + [11]
    out = prog(seeds, tm.pack_param_batch(targets),
               _pack(tm, kind, rows, targets))
    assert out[0].shape == (4, len(FNS)) and out[-1].shape == (4, DRAWS, 1024)
    for r, seed in enumerate(seeds):
        one = _port().compile_mcmc(FNS, targets[r], rows[r], **kw)(seed)
        _equal([o[r] for o in out], one)
    jt, jr = _targets(jmc), _walk_rows(jmc, kind)
    want = _jax().compile_mcmc(FNS, jt[0], jr[0], seed_batch=4,
                               param_batch=True, **kw)(
        seeds, jmc.pack_param_batch(jt), _pack(jmc, kind, jr, jt))
    for r in range(4):
        _close_to_jax([g[r] for g in out], [w[r] for w in want], stderr, True)


def test_param_batch_of_one_keeps_the_batch_axis():
    t, q = _targets(tm)[:1], [tm.Distribution.normal(0.0, 3.0)]
    prog = _port().compile_mcmc(FNS, t[0], q[0], param_batch=True, **KW)
    values, acceptance = prog([5], tm.pack_param_batch(t),
                              tm.pack_param_batch(q))
    assert values.shape == (1, len(FNS)) and acceptance.shape == (1,)
    _equal([values[0], acceptance[0]],
           _port().compile_mcmc(FNS, t[0], q[0], **KW)(5))


def test_custom_target_under_a_seed_batch():
    def bimodal(x):
        return 0.5 * np.exp(-0.5 * (x + 2) ** 2) + 0.5 * np.exp(-0.5 * (x - 2) ** 2)

    t = tm.Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    q = tm.Distribution.uniform(-6.0, 6.0)
    out = _port().compile_mcmc(FNS, t, q, seed_batch=2, return_stderr=True,
                               **KW)([1, 2])
    single = _port().compile_mcmc(FNS, t, q, return_stderr=True, **KW)
    for r, seed in enumerate([1, 2]):
        _equal([o[r] for o in out], single(seed))


# -- what the handle refuses, as the JAX package refuses it --------------------


def _n(pkg, *a):
    return pkg.Distribution.normal(*a)


ERRORS = {
    "adaptive-without-burn-in": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), pkg.RandomWalk(adapt=True), n_steps=10,
        n_burnin=0),
    "custom-target-param-batch": lambda pkg, i: i.compile_mcmc(
        FNS, pkg.Distribution.beta(2.0, 5.0), _n(pkg, 0, 1), param_batch=True,
        **KW),
    "custom-proposal-param-batch": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), pkg.Distribution.beta(2.0, 5.0), param_batch=True,
        **KW),
    "custom-walk-target-param-batch": lambda pkg, i: i.compile_mcmc(
        FNS, pkg.Distribution.beta(2.0, 5.0), pkg.RandomWalk(),
        param_batch=True, **KW),
    "samples-zero": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), _n(pkg, 0, 2), return_samples=0, **KW),
    "samples-past-steps": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), _n(pkg, 0, 2), return_samples=25, **KW),
    "samples-with-temperatures": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), pkg.RandomWalk(), return_samples=2,
        temperatures=[1.0, 2.0], **KW),
    "no-functions": lambda pkg, i: i.compile_mcmc([], _n(pkg, 0, 1),
                                                  _n(pkg, 0, 2)),
    "steps": lambda pkg, i: i.compile_mcmc(FNS, _n(pkg, 0, 1), _n(pkg, 0, 2),
                                           n_steps=0),
    "stateful": lambda pkg, i: i.compile_mcmc(FNS, _n(pkg, 0, 1),
                                              _n(pkg, 0, 2), return_state=True),
    "seed-count": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), _n(pkg, 0, 2), seed_batch=3, **KW)([1, 2]),
    "walk-pack-in-a-density-slot": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), _n(pkg, 0, 2), seed_batch=2, param_batch=True,
        **KW)([1, 2], pkg.pack_param_batch([_n(pkg, 0, 1)] * 2),
              pkg.pack_random_walk_batch([pkg.RandomWalk()] * 2,
                                         _n(pkg, 0, 1))),
    "fixed-pack-for-an-adaptive-walk": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), pkg.RandomWalk(adapt=True), seed_batch=2,
        param_batch=True, **KW)(
        [1, 2], pkg.pack_param_batch([_n(pkg, 0, 1)] * 2),
        pkg.pack_random_walk_batch([pkg.RandomWalk()] * 2, _n(pkg, 0, 1))),
    "target-family": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), _n(pkg, 0, 2), seed_batch=2, param_batch=True,
        **KW)([1, 2], pkg.pack_param_batch([pkg.Distribution.uniform(0, 1)] * 2),
              pkg.pack_param_batch([_n(pkg, 0, 1)] * 2)),
    "walk-width": lambda pkg, i: i.compile_mcmc(
        FNS, _n(pkg, 0, 1), pkg.RandomWalk(), seed_batch=2, param_batch=True,
        **KW)([1, 2], pkg.pack_param_batch([_n(pkg, 0, 1)] * 2),
              np.zeros((2, 2), np.float32)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_refusals_match_jax(case):
    with pytest.raises(Exception) as want:
        ERRORS[case](jmc, _jax())
    with pytest.raises(type(want.value)) as got:
        ERRORS[case](tm, _port())
    # A TypeError of Python's own names the method's class.
    assert str(got.value) == str(want.value) or case == "stateful"


def test_later_slices_still_raise():
    """What the handles leave for later items: WGSL source strings, a
    mesh.  More than 127/126 functions, which raised here before, run in
    passes (api/passes.py): each handle's values over 128 (127) functions
    x + c are E[x] + c on the one set of chains, every row."""
    integ = _port()
    n = _n(tm, 0, 1)
    wide1 = [(lambda c: lambda x: x + c)(float(c)) for c in range(128)]
    wide2 = [(lambda c: lambda x, y: x + c)(float(c)) for c in range(128)]
    handles = {
        "6.7": (integ.compile_mcmc(wide1, n, n, seed_batch=2, **KW), 128),
        "8.8": (integ.compile_mcmc(wide2, [n, n], [n, n], seed_batch=2,
                                   **KW), 128),
        "9.7": (integ.compile_mcmc(wide1[:127], n, tm.RandomWalk(),
                                   temperatures=[1.0, 2.0], seed_batch=2,
                                   **KW), 127),
    }
    for item, (prog, k) in handles.items():
        values = prog([3, 4])[0].numpy()
        assert values.shape == (2, k), item
        np.testing.assert_allclose(values - values[:, :1],
                                   np.tile(np.arange(float(k)), (2, 1)),
                                   atol=1e-3, err_msg=item)
    with pytest.raises(NotImplementedError, match=r"queue 1 item 3 "):
        integ.compile_mcmc([lambda x, y: x],
                           "fn f(x: f32, y: f32) -> f32 { return -x * x; }",
                           tm.RandomWalk(init_range=(-1.0, 1.0)),
                           seed_batch=2, **KW)
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12 "):
        tm.MonteCarloIntegrator(device="cpu", mesh="auto")
