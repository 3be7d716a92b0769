"""More than 127 functions in the port's 1-D and nd MCMC kernels and more
than 126 in its tempered kernel: the set runs in passes of at most 127
(126) functions, each a launch over the same chains from the same seed,
burn-in, initial state and pilot rule (``api/passes.py``).

The chains do not depend on the integrands: each pass draws the same
counter-keyed stream and makes the same accept decisions, so every pass
ends in the same states with the same accept (and swap) counts, which
the public calls check at run time.  Here, on the CPU's plain versions:
the same integrand in two groups gives bit-equal values, error bars,
split-R-hat and ESS; each group equals the port's single call over it,
bit for bit (values, acceptance, swap rate, draws, state); seed- and
param-batched handles equal their unbatched calls.  The JAX package runs
these sets on its XLA sweep (``tpu_montecarlo/api/mcmc.py:475``,
``api/mcmc_nd.py:173``, ``api/tempering.py:357``), keyed on
``jax.random``, so the port is held against it statistically: each mean
within 6 combined standard errors.
"""

import numpy as np
import pytest

import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api.passes import check_same_chains, split_groups
from tpu_montecarlo_torch.ops.mcmc_kernel import McmcOutput

SHORT = dict(n_steps=48, n_chains=1024, n_burnin=12)
N01 = tm.Distribution.normal(0.0, 1.0)
N02 = tm.Distribution.normal(0.0, 2.0)


def _bimodal(x):
    return 0.5 * np.exp(-0.5 * (x + 2) ** 2) + 0.5 * np.exp(-0.5 * (x - 2) ** 2)


def _joint(x, y):
    return -0.5 * (x * x + y * y) - 0.3 * x * y


def _one_d(c):
    return lambda x: x * x + c * x


def _two_d(c):
    return lambda x, y: x * y + c * x


# name: (functions of c, target, proposal, extra arguments, the widest
# group)
CASES = {
    "1d": (_one_d, N01, N02, {}, 127),
    "1d-walk": (_one_d, N01, tm.RandomWalk(step_size=1.0, adapt=True,
                                           init_range=(-1.0, 1.0)), {}, 127),
    "1d-hmc": (_one_d, N01, tm.HMC(step_size=0.4, n_leapfrog=4,
                                   init_range=(-1.0, 1.0)), {}, 127),
    "1d-table": (_one_d, tm.Distribution.from_pdf(_bimodal, support=(-6, 6)),
                 tm.Distribution.uniform(-6.0, 6.0), {}, 127),
    "nd": (_two_d, [N01, N01], [N02, N02], {}, 127),
    "nd-joint-walk": (_two_d, _joint, tm.RandomWalk(
        step_size=1.0, init_range=(-1.0, 1.0)), {}, 127),
    "nd-hmc": (_two_d, _joint, tm.HMC(step_size=0.4, n_leapfrog=4,
                                      init_range=(-1.0, 1.0)), {}, 127),
    "tempered": (_one_d, N01, tm.RandomWalk(step_size=1.0,
                                            init_range=(-1.0, 1.0)),
                 {"temperatures": [1.0, 2.0]}, 126),
    "tempered-nd": (_two_d, [N01, N01], [N02, N02],
                    {"temperatures": [1.0, 3.0]}, 126),
}


def _fns(name, cs):
    """The case's functions of each c in ``cs``, traced once each (the
    public calls take traced functions as they are)."""
    make = CASES[name][0]
    n_args = 1 if make is _one_d else 2
    traced = {c: tm.trace_function(make(c), n_args) for c in set(cs)}
    return [traced[c] for c in cs]


def _run(name, fns, **kw):
    _, target, proposal, extra, _ = CASES[name]
    return tm.integrate_mcmc(fns, target, proposal, device="cpu",
                             **SHORT, **extra, **kw)


OUTPUTS = dict(return_stderr=True, return_diagnostics=True, return_samples=4)


@pytest.mark.parametrize("name", list(CASES))
def test_same_integrand_in_two_groups(name):
    """128 copies of one integrand, two groups of 64: bit-equal values,
    error bars, split-R-hat and ESS at the same position of each."""
    most = CASES[name][4]
    k = 128
    assert [len(g) for g in split_groups(list(range(k)), most)] == [64, 64]
    r = _run(name, _fns(name, [0.25] * k), **OUTPUTS)
    first, second = slice(0, 64), slice(64, 128)
    assert r.values.shape == (k,) and r.stderr.shape == (k,)
    np.testing.assert_array_equal(r.values[first], r.values[second])
    np.testing.assert_array_equal(r.stderr[first], r.stderr[second])
    for key in ("r_hat", "ess"):
        assert r.diagnostics[key].shape == (k,)
        np.testing.assert_array_equal(r.diagnostics[key][first],
                                      r.diagnostics[key][second])
    assert np.all(np.isfinite(r.values))


@pytest.mark.parametrize("name", list(CASES))
def test_each_group_is_its_single_call(name):
    """Every group's values, error bars and diagnostics are the port's
    call over that group alone, bit for bit, and so are the acceptance,
    a tempered run's swap rate and the draws, which come from the first
    pass."""
    most = CASES[name][4]
    fns = _fns(name, [c / 64.0 for c in range(most + 5)])
    wide = _run(name, fns, **OUTPUTS)
    parts = [_run(name, list(g), **OUTPUTS) for g in split_groups(fns, most)]
    assert len(parts) == 2
    np.testing.assert_array_equal(
        wide.values, np.concatenate([p.values for p in parts]))
    np.testing.assert_array_equal(
        wide.stderr, np.concatenate([p.stderr for p in parts]))
    for key in ("r_hat", "ess"):
        np.testing.assert_array_equal(
            wide.diagnostics[key],
            np.concatenate([p.diagnostics[key] for p in parts]))
    for p in parts:
        assert p.acceptance_rate == wide.acceptance_rate
        if "temperatures" in CASES[name][3]:
            assert p.diagnostics["swap_rate"] == wide.diagnostics["swap_rate"]
        if wide.samples is not None:
            np.testing.assert_array_equal(p.samples, wide.samples)
    assert wide.n_functions == len(fns)


@pytest.mark.parametrize("name", ["1d", "1d-hmc", "nd", "nd-hmc"])
def test_passes_end_in_the_same_state_and_resume(name):
    """Chain state: the wide run's state is each group's, bit for bit, and
    a resumed wide run is each group's resumed run."""
    most = CASES[name][4]
    fns = _fns(name, [c / 64.0 for c in range(most + 3)])
    wide = _run(name, fns, return_state=True)
    groups = split_groups(fns, most)
    for g in groups:
        part = _run(name, list(g), return_state=True)
        np.testing.assert_array_equal(part.chain_state.x, wide.chain_state.x)
        np.testing.assert_array_equal(part.chain_state.log_p,
                                      wide.chain_state.log_p)
        assert part.acceptance_rate == wide.acceptance_rate
    again = _run(name, fns, initial_state=wide.chain_state, return_state=True)
    part = _run(name, list(groups[1]), initial_state=wide.chain_state)
    np.testing.assert_array_equal(again.values[len(groups[0]):], part.values)
    assert again.chain_state.segment == 1


def test_a_pass_with_other_chains_raises():
    """The run-time check: a pass whose final states, accept counts or
    draws differ from the first pass's fails the call."""
    rows = torch.zeros((4, 3, 3))
    x = torch.arange(8.0)
    same = McmcOutput(rows.clone(), x.clone())
    check_same_chains([McmcOutput(rows, x), same], [2, 2])
    moved = rows.clone()
    moved[1, 0, 2] = 1.0
    for out in (McmcOutput(moved, x), McmcOutput(rows, x + 1)):
        with pytest.raises(RuntimeError, match="first pass's chains"):
            check_same_chains([McmcOutput(rows, x), out], [2, 2])
    # A tempered pass's swap column counts too.
    swaps = torch.zeros((4, 3, 4))
    moved = swaps.clone()
    moved[0, 0, 3] = 1.0
    with pytest.raises(RuntimeError):
        check_same_chains([McmcOutput(swaps, x), McmcOutput(moved, x)],
                          [2, 2], swap=True)


@pytest.mark.parametrize("name", ["1d", "1d-walk", "nd", "nd-joint-walk",
                                  "tempered"])
def test_seed_batched_handles_run_in_passes(name):
    """``compile_mcmc(seed_batch=2)`` over 2 x most + 1 functions: each
    element its unbatched handle's call, bit for bit."""
    _, target, proposal, extra, most = CASES[name]
    fns = _fns(name, [c / 64.0 for c in range(most + 2)])
    integ = tm.MonteCarloIntegrator(device="cpu")
    prog = integ.compile_mcmc(fns, target, proposal, seed_batch=2,
                              return_stderr=True, **SHORT, **extra)
    one = integ.compile_mcmc(fns, target, proposal, return_stderr=True,
                             **SHORT, **extra)
    out = prog([3, 4])
    assert out[0].shape == (2, len(fns)) and out[-1].shape == (2, len(fns))
    for r, seed in enumerate((3, 4)):
        want = one(seed)
        assert len(want) == len(out)
        for got, w in zip(out, want):
            assert torch.equal(got[r], w)
    if "temperatures" not in extra:
        draws = integ.compile_mcmc(fns, target, proposal, return_samples=4,
                                   **SHORT, **extra)(3)
        assert draws[0].shape == (len(fns),)
        part = integ.compile_mcmc(fns[:most // 2 + 1], target, proposal,
                                  return_samples=4, **SHORT, **extra)(3)
        assert torch.equal(draws[-1], part[-1])


@pytest.mark.parametrize("shape", ["1d", "nd"])
def test_param_batched_handles_run_in_passes(shape):
    """``param_batch`` over 130 functions: each row its unbatched call
    under its Distributions, bit for bit."""
    integ = tm.MonteCarloIntegrator(device="cpu")
    targets = [tm.Distribution.normal(0.5, 1.0), tm.Distribution.normal(-1.0, 0.5)]
    props = [tm.Distribution.normal(0.0, 2.0), tm.Distribution.normal(0.0, 3.0)]
    if shape == "1d":
        fns = _fns("1d", [c / 64.0 for c in range(130)])
        t_rows, p_rows = targets, props
        t_pack, p_pack = tm.pack_param_batch(targets), tm.pack_param_batch(props)
    else:
        fns = _fns("nd", [c / 64.0 for c in range(130)])
        t_rows = [[t, N01] for t in targets]
        p_rows = [[p, N02] for p in props]
        t_pack = tm.pack_param_batch_nd(t_rows)
        p_pack = tm.pack_param_batch_nd(p_rows)
    prog = integ.compile_mcmc(fns, t_rows[0], p_rows[0], seed_batch=2,
                              param_batch=True, return_stderr=True, **SHORT)
    v, a, s = prog([5, 6], t_pack, p_pack)
    assert v.shape == (2, 130)
    for r in range(2):
        one = integ.compile_mcmc(fns, t_rows[r], p_rows[r],
                                 return_stderr=True, **SHORT)([5, 6][r])
        assert torch.equal(v[r], one[0]) and torch.equal(a[r], one[1])
        assert torch.equal(s[r], one[2])


@pytest.mark.parametrize("name", ["1d", "nd", "tempered"])
def test_means_match_the_jax_package_statistically(name):
    """The JAX package runs these sets on its XLA sweep: each mean within
    6 combined standard errors of the port's."""
    make, target, proposal, extra, most = CASES[name]
    fns = [make(c / 8.0) for c in range(most + 2)]
    got = _run(name, _fns(name, [c / 8.0 for c in range(most + 2)]),
               return_stderr=True, seed=7)

    def to_jax(d):
        if isinstance(d, (list, tuple)):
            return [to_jax(x) for x in d]
        if isinstance(d, tm.RandomWalk):
            return jmc.RandomWalk(step_size=1.0, init_range=(-1.0, 1.0))
        return jmc.Distribution.normal(d.params["mean"], d.params["std"])

    want = jmc.integrate_mcmc(fns, to_jax(target), to_jax(proposal), seed=7,
                              return_stderr=True, **SHORT, **extra)
    assert want.values.shape == got.values.shape
    tol = 6 * np.hypot(got.stderr, want.stderr) + 1e-6
    assert np.all(np.abs(got.values - want.values) < tol)
    assert abs(got.acceptance_rate - want.acceptance_rate) < 0.05


def test_wide_mcmc_caches_one_program_per_group(program_cache):
    """One program per group, keyed by content: a second call with the
    same functions builds none."""
    fns = _fns("1d", [c / 64.0 for c in range(130)])
    _run("1d", fns)
    assert len(program_cache._store) == 2
    _run("1d", _fns("1d", [c / 64.0 for c in range(130)]))
    assert len(program_cache._store) == 2
