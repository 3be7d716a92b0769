"""Chain state and resume in the port's 1-D and nd MCMC paths
(``integrate_mcmc(..., return_state=True)`` and ``initial_state=``)
against the JAX package.

* 1-D, chain for chain: the plain version against the interpret-mode JAX
  kernel (``build_mcmc_fn_pallas(..., with_state=True,
  use_init_state=True, interpret=True)``, directly and through the JAX
  package's ``backend="pallas"`` calls) over two segments: a fresh
  stateful run, then a run resumed from the JAX kernel's state.  The two
  draw the same streams, the resumed one under the seed word with the
  segment folded in, and start from the same state, so the states differ
  only by last-bit differences of torch's and XLA's ``log``, ``exp`` and
  ``erfinv``: every chain's x within X_ULPS ulp and log_p within
  LOGP_ULPS ulp of max(1, |log_p|) (a table's log density interpolates
  values of order 1), but for at most MAX_SPLIT of the chains (a decision
  that such a bit flips; measured: none).  Measured over 30 steps: x
  within 4 ulp, log_p within 19 ulp of a Beta table's value near 0.  A walk's
  (and HMC's) state is a sum of steps whose normal draws differ in their
  last bit, so there x is held within WALK_RTOL of 1 + |x| instead
  (measured up to 254 ulp of an x near 0, 3e-6 of 1 + |x|).
* A fresh stateful run is segment 0: the stateless run's chains, values
  and acceptance bit for bit (a CUSTOM proposal's stateful run reads its
  full inverse and log table, so it draws other chains, as the JAX
  kernel's does).
* The error cases, word for word as the JAX package raises them.
* The cases of ``tests/test_mcmc_resume.py`` and
  ``tests/test_sampler_logq.py`` on the port (a stateful run's CUSTOM
  proposal takes its full inverse and faithful q-table).
* nd state: the JAX package runs it on its XLA sweep, keyed on
  ``jax.random``; the port keeps it in its nd kernel under the counter
  stream.  So the two are held statistically: both packages' resumed
  segments within ND_ATOL of the exact moments and of each other (about
  10 standard errors at their effective sample size, ~1e5).  The port's
  own nd segment 0 equals its stateless run bit for bit.

The CUDA kernels are held against these plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import contextlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo.ops.mcmc_pallas import _SEGMENT_MIX, build_mcmc_fn_pallas
from tpu_montecarlo.ops.mcmc_pallas import plan_mcmc_grid as j_plan_mcmc_grid
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.tracing import trace_function as j_trace

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import mcmc as api_mcmc
from tpu_montecarlo_torch.api import mcmc_nd as api_nd
from tpu_montecarlo_torch.api.device import mcmc_dim_tables
from tpu_montecarlo_torch.ops.lower import to_torch
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    ChainStart,
    McmcConfig,
    Mode,
    mcmc_cuda,
    mcmc_finish,
    mcmc_reference,
    plan_chains,
    plan_mcmc_grid,
    seed_word,
)
from tpu_montecarlo_torch.ops.mcmc_nd_kernel import mcmc_nd_cuda, nd_seed_word
from tpu_montecarlo_torch.sampling import DistKind

X_ULPS, LOGP_ULPS = 8, 8
WALK_RTOL = 2e-5
MAX_SPLIT, SPLIT_RTOL = 0.01, 1e-4
N_CHAINS, N_STEPS, N_BURNIN = 1024, 30, 10
ND_ATOL = 0.03
_GAP_X = np.linspace(0.0, 1.0, 2048)
_GAP_P = np.where((_GAP_X > 0.4) & (_GAP_X < 0.6), 0.0, 1.0)


@contextlib.contextmanager
def _as_xla():
    """One torch thread with float32 subnormals flushed, as XLA's CPU
    backend runs (``tests/test_torch_tempering.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _assert_states_agree(got, want, walk=False):
    """Chain for chain: x and log_p within their bounds (a walk's x within
    WALK_RTOL of 1 + |x|) but for at most MAX_SPLIT split chains."""
    assert got.x.shape == want.x.shape and got.segment == want.segment
    split = np.abs(got.x - want.x) > SPLIT_RTOL * (1.0 + np.abs(want.x))
    assert split.mean() <= MAX_SPLIT, f"{split.mean():.2%} of the chains split"
    keep = ~split
    if walk:
        assert np.all(np.abs(got.x - want.x)[keep]
                      <= WALK_RTOL * (1.0 + np.abs(want.x[keep])))
        assert np.all(np.abs(got.log_p - want.log_p)[keep]
                      <= WALK_RTOL * (1.0 + np.abs(want.log_p[keep])))
        return
    assert _ulps(got.x, want.x)[keep].max() <= X_ULPS
    scale = np.maximum(np.abs(want.log_p[keep]), 1.0).astype(np.float32)
    assert np.all(np.abs(got.log_p - want.log_p)[keep]
                  <= LOGP_ULPS * np.spacing(scale))


# name: (target, proposal) of either package
CASES = {
    "independence-normal": (lambda p: p.Distribution.normal(0.0, 1.0),
                            lambda p: p.Distribution.normal(0.0, 2.0)),
    "exponential-uniform": (lambda p: p.Distribution.exponential(2.0),
                            lambda p: p.Distribution.uniform(0.0, 4.0)),
    "table-sampler": (lambda p: p.Distribution.beta(2.0, 5.0),
                      lambda p: p.Distribution.beta(2.0, 5.0)),
    "table-target": (lambda p: p.Distribution.beta(2.0, 5.0),
                     lambda p: p.Distribution.uniform(0.0, 1.0)),
    "gapped": (lambda p: p.Distribution.uniform(0.0, 1.0),
               lambda p: p.Distribution.from_pdf_table(_GAP_X, _GAP_P)),
    "walk": (lambda p: p.Distribution.normal(0.0, 1.0),
             lambda p: p.RandomWalk(step_size=0.8)),
    "hmc": (lambda p: p.Distribution.normal(0.5, 1.5),
            lambda p: p.HMC(step_size=0.3, n_leapfrog=5)),
}
FNS = [lambda x: x, lambda x: x * x]


def _segments(pkg, integ, case, first_state=None):
    """Two segments of ``case``: fresh, then resumed (from
    ``first_state`` when given, else from the first segment's)."""
    target, proposal = CASES[case]
    kw = dict(n_steps=N_STEPS, n_chains=N_CHAINS, seed=5, return_state=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the JAX kernel, not its XLA sweep
        r0 = integ.integrate_mcmc(FNS, target(pkg), proposal(pkg),
                                  n_burnin=N_BURNIN, **kw)
        start = r0.chain_state if first_state is None else first_state
        r1 = integ.integrate_mcmc(FNS, target(pkg), proposal(pkg),
                                  n_burnin=0, initial_state=start, **kw)
    return r0, r1


@pytest.mark.parametrize("case", list(CASES))
def test_two_segments_match_jax_interpret_kernel(case):
    j0, j1 = _segments(jmc, jmc.MonteCarloIntegrator(backend="pallas"), case)
    with _as_xla():
        p0, p1 = _segments(tm, tm.MonteCarloIntegrator(device="cpu"), case,
                           tm.McmcState.from_reference(j0.chain_state))
    for got, want in ((p0, j0), (p1, j1)):
        _assert_states_agree(got.chain_state, want.chain_state,
                             walk=case in ("walk", "hmc"))
        np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-5)
        assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-4
    assert (p0.chain_state.segment, p1.chain_state.segment) == (0, 1)


def test_resume_matches_the_jax_kernel_built_with_state():
    # build_mcmc_fn_pallas itself, over a fresh segment and a resumed one
    # (use_init_state), independence N(0, 2) -> N(0, 1).
    fns = tuple(j_trace(f) for f in FNS)
    chains = j_plan_mcmc_grid(N_CHAINS)[2]
    dummy = jnp.zeros(1, jnp.float32)
    tables = [dummy] * 6
    prop, targ = np.float32([0.0, 2.0]), np.float32([0.0, 1.0])
    torch_fns = [to_torch(tm.trace_function(f)) for f in FNS]
    grid = plan_mcmc_grid(plan_chains(N_CHAINS, None))
    params = torch.tensor([0.0, 2.0, 0.0, 0.0, 0.0, 1.0])
    x0 = logp0 = jnp.zeros(chains, jnp.float32)
    start = None
    for segment in (0, 1, 2):
        resume = segment > 0
        run = build_mcmc_fn_pallas(
            fns, JKind.NORMAL, JKind.NORMAL, N_STEPS, 0 if resume else N_BURNIN,
            N_CHAINS, interpret=True, with_state=True, use_init_state=resume)
        values, acc, x_f, logp_f = run(np.uint32(9), prop, targ, *tables, x0,
                                       logp0, jnp.int32(segment))
        cfg = McmcConfig(Mode.INDEPENDENCE, DistKind.NORMAL, DistKind.NORMAL,
                         N_STEPS, 0 if resume else N_BURNIN, with_state=True,
                         use_init_state=resume)
        with _as_xla():
            out = mcmc_reference(torch_fns, cfg, params, 9, grid,
                                 segment=segment, start=start)
        got = tm.McmcState(out.x_final.numpy(), out.logp_final.numpy(), segment)
        want = tm.McmcState(np.asarray(x_f).reshape(-1),
                            np.asarray(logp_f).reshape(-1), segment)
        _assert_states_agree(got, want)
        got_values = mcmc_finish(out, grid, cfg, len(FNS))[0].numpy()
        np.testing.assert_allclose(got_values, np.asarray(values), atol=1e-5)
        # The next segment starts from the JAX kernel's state.
        x0, logp0 = x_f.reshape(-1), logp_f.reshape(-1)
        start = ChainStart(torch.from_numpy(np.array(x0)),
                           torch.from_numpy(np.array(logp0)))


@pytest.mark.parametrize("segment", [0, 1, 2, 7, 123456, 2**31 - 1])
def test_segment_mix_is_the_jax_kernels(segment):
    # mcmc_pallas.py:639-642: seed_word ^ (segment * 0x9E3779B1) in int32.
    word = np.uint32(1234) ^ np.uint32(0x5BD1E995)
    with np.errstate(over="ignore"):
        mix = np.int32(segment) * _SEGMENT_MIX
    want = int(np.int32(word.view(np.int32) ^ mix).view(np.uint32))
    assert seed_word(1234, segment) == want
    assert (seed_word(1234, segment) == seed_word(1234)) == (segment == 0)
    assert nd_seed_word(7, 0) == nd_seed_word(7)


@pytest.mark.parametrize("case", ["independence-normal", "table-target",
                                  "walk", "hmc"])
def test_fresh_stateful_run_is_the_stateless_run(case, monkeypatch):
    target, proposal = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_mcmc, "mcmc_cuda", spy)
    integ = tm.MonteCarloIntegrator(device="cpu")
    kw = dict(n_steps=N_STEPS, n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=3)
    stateless = integ.integrate_mcmc(FNS, target(tm), proposal(tm), **kw)
    stateful = integ.integrate_mcmc(FNS, target(tm), proposal(tm),
                                    return_state=True, **kw)
    np.testing.assert_array_equal(stateful.values, stateless.values)
    assert stateful.acceptance_rate == stateless.acceptance_rate
    assert stateful.chain_state.segment == 0
    np.testing.assert_array_equal(outs[1].x_final, outs[0].x_final)
    np.testing.assert_array_equal(stateful.chain_state.x, outs[1].x_final)


def test_nd_fresh_stateful_run_is_the_stateless_run():
    n, n2 = tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(0.0, 2.0)
    integ = tm.MonteCarloIntegrator(device="cpu")
    for proposal in ([n2, n2], tm.RandomWalk(step_size=0.9)):
        kw = dict(n_steps=N_STEPS, n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=3)
        a = integ.integrate_mcmc([lambda x, y: x * y], [n, n], proposal, **kw)
        b = integ.integrate_mcmc([lambda x, y: x * y], [n, n], proposal,
                                 return_state=True, **kw)
        np.testing.assert_array_equal(a.values, b.values)
        assert b.chain_state.x.shape == (2, 1024)
        assert b.chain_state.ndim_state == 2 and b.chain_state.segment == 0


# -- error cases ------------------------------------------------------------------


def _both_raise(call):
    with pytest.raises(ValueError) as want:
        call(jmc, jmc.MonteCarloIntegrator(backend="pallas"))
    with pytest.raises(ValueError) as got:
        call(tm, tm.MonteCarloIntegrator(device="cpu"))
    return str(got.value), str(want.value)


def _run(pkg, integ, **kwargs):
    target = kwargs.pop("target", pkg.Distribution.normal(0.0, 1.0))
    proposal = kwargs.pop("proposal", pkg.Distribution.normal(0.0, 2.0))
    return integ.integrate_mcmc([lambda x: x], target, proposal, n_steps=10,
                                n_chains=256, n_burnin=2, **kwargs)


@pytest.mark.parametrize("kwargs", [
    {"return_stderr": True, "return_state": True},
    {"return_diagnostics": True, "return_state": True},
    {"return_samples": 3, "return_state": True},
    {"return_stderr": True, "initial_state": "state"},
    {"return_samples": 3, "initial_state": "state"},
    {"temperatures": [1.0, 2.0], "return_state": True},
    {"temperatures": [1.0, 2.0], "initial_state": "state"},
    {"proposal": "adaptive", "return_state": True},
    {"proposal": "adaptive", "initial_state": "state"},
    {"proposal": "adaptive-hmc", "return_state": True},
], ids=lambda k: "-".join(f"{a}={b}" if a == "proposal" else a for a, b in k.items()))
def test_stateless_only_options_raise_as_jax(kwargs):
    def call(pkg, integ):
        kw = dict(kwargs)
        if kw.get("initial_state") == "state":
            kw["initial_state"] = pkg.McmcState(np.zeros(1024, np.float32),
                                                np.zeros(1024, np.float32))
        if kw.get("proposal") == "adaptive":
            kw["proposal"] = pkg.RandomWalk(adapt=True)
        if kw.get("proposal") == "adaptive-hmc":
            kw["proposal"] = pkg.HMC(adapt=True)
        return _run(pkg, integ, **kw)

    got, want = _both_raise(call)
    assert got == want


def test_chain_count_mismatch_raises_as_jax():
    def call(pkg, integ):
        bad = pkg.McmcState(np.zeros(100, np.float32), np.zeros(100, np.float32))
        return _run(pkg, integ, initial_state=bad)

    got, want = _both_raise(call)
    # The port plans the JAX kernel's chains (1024 for 256).
    assert got == want == (
        "initial_state has 100 chains but this run plans 1024; pass the "
        "state back with the same n_chains/target_threads (and the backend "
        "that produced it)")


def test_nd_state_shape_mismatch_raises():
    n = tm.Distribution.normal(0.0, 1.0)
    bad = tm.McmcState(np.zeros(1024, np.float32), np.zeros(1024, np.float32))
    with pytest.raises(ValueError, match=r"initial_state carries x of shape "
                       r"\(1024,\) but this nd run plans \(2, 1024\)"):
        tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
            [lambda x, y: x], [n, n], [n, n], n_steps=10, initial_state=bad)


def test_kernel_configs_refuse_what_the_jax_kernel_refuses():
    base = (Mode.INDEPENDENCE, DistKind.NORMAL, DistKind.NORMAL, 10, 0)
    for kw, msg in (
        (dict(use_init_state=True), "use_init_state requires with_state"),
        (dict(with_state=True, with_stderr=True), "with_stderr applies"),
        (dict(with_state=True, samples=2), "with_samples applies"),
        (dict(hmc_leapfrog=4), "hmc_leapfrog requires a walk mode"),
    ):
        with pytest.raises(ValueError, match=msg):
            McmcConfig(*base, **kw)
    with pytest.raises(ValueError, match="rw_adapt is stateless-only"):
        McmcConfig(Mode.ADAPTIVE, DistKind.NORMAL, DistKind.NORMAL, 10, 2,
                   with_state=True, use_init_state=True)
    with pytest.raises(ValueError, match="logq from its log table"):
        McmcConfig(Mode.INDEPENDENCE, DistKind.CUSTOM, DistKind.NORMAL, 10, 0,
                   with_state=True)


# -- tests/test_mcmc_resume.py on the port -------------------------------------


@pytest.fixture(scope="module")
def integ():
    return tm.MonteCarloIntegrator(device="cpu")


_N01 = tm.Distribution.normal(0.0, 1.0)
_N02 = tm.Distribution.normal(0.0, 2.0)


def test_state_returned(integ):
    r = integ.integrate_mcmc([lambda x: x], _N01, _N02, n_steps=200,
                             n_chains=256, n_burnin=50, return_state=True)
    assert isinstance(r.chain_state, tm.McmcState)
    # The JAX kernel's planner: 256 chains run as 1024.
    assert r.chain_state.n_chains == 1024
    assert np.all(np.isfinite(r.chain_state.x))
    assert np.all(np.isfinite(r.chain_state.log_p))


def test_state_not_returned_by_default(integ):
    r = integ.integrate_mcmc([lambda x: x], _N01, _N02, n_steps=100,
                             n_chains=256, n_burnin=10)
    assert r.chain_state is None


def test_resume_continues_chains(integ):
    fns = [lambda x: x, lambda x: x * x]
    r1 = integ.integrate_mcmc(fns, _N01, _N02, n_steps=500, n_chains=512,
                              n_burnin=200, return_state=True)
    r2 = integ.integrate_mcmc(fns, _N01, _N02, n_steps=500, n_chains=512,
                              n_burnin=0, initial_state=r1.chain_state,
                              return_state=True, seed=43)
    assert abs(r2.values[0]) < 0.15
    assert abs(r2.values[1] - 1.0) < 0.25
    assert not np.array_equal(r1.chain_state.x, r2.chain_state.x)
    assert r2.chain_state.segment == 1


def test_resumed_estimate_uses_given_state(integ):
    # Every chain pinned at 5 with a log density no proposal can beat.
    pinned = tm.McmcState(x=np.full(1024, 5.0, np.float32),
                          log_p=np.full(1024, 1e6, np.float32))
    r = integ.integrate_mcmc([lambda x: x], _N01, _N01, n_steps=50,
                             n_chains=256, n_burnin=0, initial_state=pinned)
    assert r.values[0] == pytest.approx(5.0, abs=1e-4)
    assert r.acceptance_rate == 0.0


def test_chain_count_mismatch_rejected(integ):
    bad = tm.McmcState(np.zeros(100, np.float32), np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="chains"):
        integ.integrate_mcmc([lambda x: x], _N01, _N02, n_steps=10,
                             n_chains=256, initial_state=bad)


def test_resume_draws_fresh_streams(integ):
    r1 = integ.integrate_mcmc([lambda x: x], _N01, _N02, n_steps=100,
                              n_chains=256, n_burnin=0, return_state=True,
                              seed=21)
    r2 = integ.integrate_mcmc([lambda x: x], _N01, _N02, n_steps=100,
                              n_chains=256, n_burnin=0,
                              initial_state=r1.chain_state, return_state=True,
                              seed=21)
    assert r1.values[0] != r2.values[0]


def test_custom_target_resume(integ):
    beta, q = tm.Distribution.beta(2.0, 5.0), tm.Distribution.uniform(0.0, 1.0)
    r1 = integ.integrate_mcmc([lambda x: x], beta, q, n_steps=300,
                              n_chains=512, n_burnin=150, return_state=True)
    r2 = integ.integrate_mcmc([lambda x: x], beta, q, n_steps=300,
                              n_chains=512, n_burnin=0,
                              initial_state=r1.chain_state, seed=43)
    assert abs(r1.values[0] - 2.0 / 7.0) < 0.05
    assert abs(r2.values[0] - 2.0 / 7.0) < 0.05


def test_state_from_the_jax_package_resumes_on_the_port(integ):
    j = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
        [lambda x: x], jmc.Distribution.normal(0.0, 1.0),
        jmc.Distribution.normal(0.0, 2.0), n_steps=50, n_chains=256,
        n_burnin=20, return_state=True)
    state = tm.McmcState.from_reference(j.chain_state)
    assert (state.n_chains, state.ndim_state, state.segment) == (1024, 1, 0)
    r = integ.integrate_mcmc([lambda x: x * x], _N01, _N02, n_steps=200,
                             n_chains=256, n_burnin=0, initial_state=state,
                             return_state=True)
    assert abs(r.values[0] - 1.0) < 0.2 and r.chain_state.segment == 1


# -- tests/test_sampler_logq.py on the port ------------------------------------


def test_stateful_run_keeps_table_logq_path(integ):
    beta = lambda: tm.Distribution.beta(2.0, 5.0)  # noqa: E731
    r1 = integ.integrate_mcmc([lambda x: x], beta(), beta(), n_steps=1000,
                              n_chains=512, n_burnin=200, seed=5,
                              return_state=True)
    r2 = integ.integrate_mcmc([lambda x: x], beta(), beta(), n_steps=1000,
                              n_chains=512, n_burnin=0, seed=6,
                              initial_state=r1.chain_state)
    assert r2.values[0] == pytest.approx(2.0 / 7.0, abs=0.02)


def test_stateful_run_stages_full_inverse_and_q_table():
    from tpu_montecarlo_torch.api.device import _mcmc_prop_inverse
    from tpu_montecarlo_torch.sampling import dist_spec_of

    beta, n = tm.Distribution.beta(2.0, 5.0), tm.Distribution.normal(0.3, 0.2)
    spec = dist_spec_of(beta)
    sampler = mcmc_dim_tables(beta, n, "cpu")
    stateful = mcmc_dim_tables(beta, n, "cpu", stateful=True)
    assert sampler.q is None
    assert sampler.inv.t.shape[0] == _mcmc_prop_inverse(beta, spec).shape[0]
    assert stateful.q is not None
    np.testing.assert_array_equal(stateful.inv.t.numpy(), spec.x_table)
    integ = tm.MonteCarloIntegrator(device="cpu")
    traced = integ._trace_user_functions([lambda x: x])
    cfg = integ._mcmc_kernel_program(traced, n, beta, 10, 0, False,
                                     with_state=True)[1]
    assert cfg.prop_gapped and cfg.with_state


def test_unfaithful_q_table_runs_stateless_and_names_item_when_stateful(integ):
    # A spiky irregular table whose uniform-grid q-table fails the 0.01-nat
    # fidelity check: sampler mode needs none, so the stateless run takes
    # the kernel; a stateful run needs it, and the JAX package then runs
    # its XLA sweep.  The port runs it in its kernel on the "full" route
    # (queue 1 item 6.8, which raised here before): the inverse at full
    # length, logq from the full irregular log table.
    x = np.sort(np.concatenate([np.linspace(0.0, 4.0, 900),
                                np.linspace(1.999, 2.001, 200)]))
    pv = 0.2 + np.exp(-0.5 * ((x - 2.0) / 0.0005) ** 2) * 50.0
    target = tm.Distribution.normal(2.0, 0.8)
    kw = dict(n_steps=200, n_chains=256, n_burnin=50, seed=5)
    r = integ.integrate_mcmc([lambda v: v], target,
                             tm.Distribution.from_pdf_table(x, pv), **kw)
    assert abs(r.values[0] - 2.0) < 0.1
    s = integ.integrate_mcmc([lambda v: v], target,
                             tm.Distribution.from_pdf_table(x, pv),
                             return_state=True, **kw)
    assert abs(s.values[0] - 2.0) < 0.1
    assert s.chain_state is not None
    with pytest.warns(UserWarning, match="XLA backend"):
        jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            [lambda v: v], jmc.Distribution.normal(2.0, 0.8),
            jmc.Distribution.from_pdf_table(x, pv), return_state=True, **kw)


# -- nd state -------------------------------------------------------------------

ND_FNS = [lambda x, y: x, lambda x, y: y, lambda x, y: x * y,
          lambda x, y: x * x]
ND_EXACT = [0.0, 1.0, 0.0, 1.0]


def _nd_segments(pkg, integ, proposal):
    n01, n11 = pkg.Distribution.normal(0.0, 1.0), pkg.Distribution.normal(1.0, 1.0)
    kw = dict(n_steps=300, n_chains=1024, return_state=True)
    r0 = integ.integrate_mcmc(ND_FNS, [n01, n11], proposal(pkg), n_burnin=100,
                              seed=11, **kw)
    r1 = integ.integrate_mcmc(ND_FNS, [n01, n11], proposal(pkg), n_burnin=0,
                              seed=11, initial_state=r0.chain_state, **kw)
    return r0, r1


@pytest.mark.parametrize("proposal", [
    lambda p: [p.Distribution.normal(0.0, 2.0), p.Distribution.normal(1.0, 2.0)],
    lambda p: p.RandomWalk(step_size=[1.5, 1.5]),
], ids=["independence", "walk"])
def test_nd_state_matches_jax_xla_route_statistically(proposal, monkeypatch):
    j0, j1 = _nd_segments(jmc, jmc.MonteCarloIntegrator(), proposal)
    outs = []

    def spy(*args):
        outs.append(mcmc_nd_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_nd, "mcmc_nd_cuda", spy)
    p0, p1 = _nd_segments(tm, tm.MonteCarloIntegrator(device="cpu"), proposal)
    assert len(outs) == 2 and mcmc_nd_cuda.state_launches == 0
    assert p1.chain_state.x.shape == (2, 1024) and p1.chain_state.segment == 1
    for got, want in ((p0, j0), (p1, j1)):
        assert np.all(np.abs(got.values - ND_EXACT) < ND_ATOL), got.values
        assert np.all(np.abs(want.values - ND_EXACT) < ND_ATOL), want.values
        assert np.all(np.abs(got.values - want.values) < ND_ATOL)
    # The resumed segment starts where the first ended: its start's log
    # density is the one the first segment returned, not recomputed.
    np.testing.assert_array_equal(outs[0].x_final.numpy(), p0.chain_state.x)
    np.testing.assert_array_equal(outs[0].logp_final.numpy(),
                                  p0.chain_state.log_p)


def test_nd_resume_uses_given_state():
    n = tm.Distribution.normal(0.0, 1.0)
    pinned = tm.McmcState(x=np.full((2, 1024), 5.0, np.float32),
                          log_p=np.full(1024, 1e6, np.float32))
    r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
        [lambda x, y: x + y], [n, n], [n, n], n_steps=40, n_chains=256,
        n_burnin=0, initial_state=pinned)
    assert r.values[0] == pytest.approx(10.0, abs=1e-4)
    assert r.acceptance_rate == 0.0
