"""The port's 1-D MCMC slice (``integrate_mcmc``) against the JAX package.

The port's plain PyTorch version runs, chain for chain, the chains of the
JAX kernel ``build_mcmc_fn_pallas`` in interpret mode (its ``CounterRng``
stream).  Only a last-bit difference between torch's and XLA's ``log``,
``exp`` or ``erfinv`` can flip an accept decision, so the tests hold:

* per chain: at most 1% of the final states more than 1e-4 (relative)
  apart (measured: none, with last-bit differences up to 1.5e-5 in the
  walks' states, which sum ulp-sized steps);
* the means within 1e-5 absolute (float32 summation order of values of
  order 1; measured up to 3e-8);
* the acceptance rates within 1e-4 (measured: equal);
* the error bars within rel 1e-3 (blocks of 32 chains against programs
  of 1024 as the unit of Chan's recombination; measured ~1e-6).

Inputs are made from seeds; sizes follow the JAX package's own
interpret-mode MCMC tests (1024 chains, tens of steps).  The CUDA kernel
is held against the plain version in ``test_torch_cuda.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)
from torch_cache import program_cache  # noqa: F401  (a cache per test)

import jax.numpy as jnp
import tpu_montecarlo as jmc
from tpu_montecarlo.ops.mcmc_pallas import build_mcmc_fn_pallas
from tpu_montecarlo.ops.mcmc_pallas import plan_mcmc_grid as j_plan_mcmc_grid
from tpu_montecarlo.ops.mcmc_xla import plan_chains as j_plan_chains
from tpu_montecarlo.sampling import DistKind as JKind
from tpu_montecarlo.sampling import analytic_log_pdf as j_analytic_log_pdf
from tpu_montecarlo.tracing import trace_function as j_trace

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    McmcConfig,
    McmcProgram,
    Mode,
    mcmc_cuda,
    mcmc_finish,
    mcmc_reference,
    plan_chains,
    plan_mcmc_grid,
)
from tpu_montecarlo_torch.ops.lower import to_torch
from tpu_montecarlo_torch.sampling import DistKind, analytic_log_pdf

REPO = Path(__file__).resolve().parents[1]

FNS = [
    lambda x: x,
    lambda x: x * x,
    lambda x: np.sin(x),
    lambda x: x > 1.0,
]
N_CHAINS, N_STEPS, N_BURNIN = 1024, 64, 16
_N, _U, _E = DistKind.NORMAL, DistKind.UNIFORM, DistKind.EXPONENTIAL
_WALK = [0.8, -2.3, 2.3, 0.44]
# id: (mode, proposal kind, target kind, (6,) params row, with_stderr)
CASES = {
    "independence-normal": (Mode.INDEPENDENCE, _N, _N, [0.0, 2.0, 0, 0, 0.0, 1.0], False),
    "uniform-exponential": (Mode.INDEPENDENCE, _U, _E, [0.0, 6.0, 0, 0, 1.5, 0.0], False),
    "exponential-exponential": (Mode.INDEPENDENCE, _E, _E, [1.0, 0.0, 0, 0, 2.0, 0.0], False),
    "random-walk": (Mode.RANDOM_WALK, _N, _N, _WALK + [0.0, 1.0], False),
    "adaptive-walk": (Mode.ADAPTIVE, _N, _N, _WALK + [0.0, 1.0], False),
    "stderr": (Mode.INDEPENDENCE, _N, _N, [0.0, 2.0, 0, 0, 0.0, 1.0], True),
    "adaptive-walk-stderr-exponential": (
        Mode.ADAPTIVE, _E, _E, [0.5, 0.1, 3.0, 0.44, 2.0, 0.0], True
    ),
}


def _jax_run(case, n_chains, n_steps, n_burnin, seed=42, with_state=False):
    """The interpret-mode JAX kernel: (values, acceptance[, x_final]
    | stderr)."""
    mode, prop, targ, row, stderr = CASES[case]
    walk = mode != Mode.INDEPENDENCE
    run = build_mcmc_fn_pallas(
        tuple(j_trace(f) for f in FNS), JKind(int(prop)), JKind(int(targ)),
        n_steps, n_burnin, j_plan_chains(n_chains, None),
        interpret=True, with_state=with_state,
        with_stderr=stderr and not with_state,
        random_walk=walk, rw_adapt=mode == Mode.ADAPTIVE,
    )
    dummy = jnp.zeros(1, jnp.float32)
    prop_row = np.asarray(row[:4] if walk else row[:2], np.float32)
    args = [np.uint32(seed), prop_row, np.asarray(row[4:], np.float32)]
    args += [dummy] * 6
    if with_state:
        chains = j_plan_mcmc_grid(j_plan_chains(n_chains, None))[2]
        args += [jnp.zeros(chains), jnp.zeros(chains), jnp.int32(0)]
    return [np.asarray(o) for o in run(*args)]


def _port_run(case, n_chains, n_steps, n_burnin, seed=42):
    mode, prop, targ, row, stderr = CASES[case]
    cfg = McmcConfig(mode, prop, targ, n_steps, n_burnin, stderr)
    grid = plan_mcmc_grid(plan_chains(n_chains, None))
    fns = [to_torch(tm.trace_function(f)) for f in FNS]
    params = torch.tensor(row, dtype=torch.float32)
    out = mcmc_reference(fns, cfg, params, seed, grid)
    values, acc, se = mcmc_finish(out, grid, cfg, len(FNS))
    return out.x_final.numpy(), values.numpy(), float(acc), se


def _assert_chains_agree(x_port, x_jax):
    assert x_port.shape == x_jax.shape
    split = np.abs(x_port - x_jax) > 1e-4 * (1.0 + np.abs(x_jax))
    assert split.mean() <= 0.01, f"{split.mean():.2%} of the chains split"


# -- planning -----------------------------------------------------------------


@pytest.mark.parametrize(
    "n_chains,target_threads,n_dev",
    [
        (1, None, 1), (255, None, 1), (256, None, 1), (1000, None, 1),
        (4096, None, 1), (5000, 2048, 1), (100, 300, 1), (1000, None, 3),
        (10, None, 8), (70_000, None, 1),
    ],
)
def test_plan_chains_matches_jax(n_chains, target_threads, n_dev):
    assert plan_chains(n_chains, target_threads, n_dev) == j_plan_chains(
        n_chains, target_threads, n_dev
    )


@pytest.mark.parametrize(
    "total", [256, 1024, 1280, 4096, 8192, 8193, 20_000, 65_536, 1_000_000]
)
def test_plan_mcmc_grid_matches_jax(total):
    grid = plan_mcmc_grid(total)
    assert (grid.programs, grid.rows, grid.chains_actual) == j_plan_mcmc_grid(
        total
    )
    assert grid.chains_actual == grid.programs * grid.chains_per_program


# -- log densities, quantiles, RandomWalk -------------------------------------

LOG_PDF_CASES = [
    (_U, -1.0, 2.5),
    (_N, 0.5, 1.5),
    (_E, 0.5, 0.0),
]


@pytest.mark.parametrize(
    "kind,p1,p2", LOG_PDF_CASES, ids=["uniform", "normal", "exponential"]
)
def test_analytic_log_pdf_matches_jax(kind, p1, p2):
    rs = np.random.default_rng(int(kind) + 3)
    # Points inside and outside the support, and both uniform bounds.
    x = np.concatenate([
        rs.uniform(-6.0, 8.0, 4096), [p1, p2, -0.0, 0.0, -1e-30]
    ]).astype(np.float32)
    p1_32, p2_32 = np.float32(p1), np.float32(p2)
    want = np.asarray(j_analytic_log_pdf(JKind(int(kind)), p1_32, p2_32, x))
    got = analytic_log_pdf(
        kind, torch.tensor(p1_32), torch.tensor(p2_32), torch.from_numpy(x)
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    if kind != _N:
        assert np.any(got == -100.0)  # the floor out of support


FAMILIES = [
    ("uniform", (-1.0, 2.5)),
    ("normal", (0.5, 1.5)),
    ("exponential", (2.0,)),
]


@pytest.mark.parametrize("name,args", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_quantile_matches_jax(name, args):
    jd = getattr(jmc.Distribution, name)(*args)
    td = tm.Distribution.from_reference(jd)
    for q in (1e-6, 0.01, 0.3, 0.5, 0.99, 1.0 - 1e-9):
        assert td.quantile(q) == jd.quantile(q)
    for q in (0.0, 1.0, -0.5):
        with pytest.raises(ValueError, match="q must be in"):
            td.quantile(q)


RW_KWARGS = [
    {},
    {"step_size": 0.3, "adapt": True, "target_accept": 0.3},
    {"init_range": (-1.0, 4.0)},
    {"init_range": [(0.5, 0.7)], "step_size": [2.0]},
]


@pytest.mark.parametrize("kwargs", RW_KWARGS, ids=["default", "adapt", "range", "per-dim"])
@pytest.mark.parametrize("name,args", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_random_walk_pack_params_matches_jax(kwargs, name, args):
    jd = getattr(jmc.Distribution, name)(*args)
    jrw = jmc.RandomWalk(**kwargs)
    want = jrw.pack_params(jd)
    got = tm.RandomWalk(**kwargs).pack_params(tm.Distribution.from_reference(jd))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    carried = tm.RandomWalk.from_reference(jrw)
    np.testing.assert_array_equal(
        carried.pack_params(tm.Distribution.from_reference(jd)), want
    )
    assert repr(carried) == repr(jrw)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"step_size": 0.0},
        {"step_size": [1.0, -1.0]},
        {"target_accept": 1.0},
        {"init_range": (2.0, 1.0)},
        {"init_range": [(0.0, 1.0), (3.0, 3.0)]},
    ],
)
def test_random_walk_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jmc.RandomWalk(**kwargs)
    with pytest.raises(ValueError) as got:
        tm.RandomWalk(**kwargs)
    assert str(got.value) == str(want.value)


def test_random_walk_wrong_dimension_raises_as_jax():
    d = tm.Distribution.normal(0.0, 1.0)
    for kwargs in ({"step_size": [1.0, 2.0]}, {"init_range": [(0, 1), (1, 2)]}):
        with pytest.raises(ValueError) as want:
            jmc.RandomWalk(**kwargs).pack_params(jmc.Distribution.normal(0.0, 1.0))
        with pytest.raises(ValueError) as got:
            tm.RandomWalk(**kwargs).pack_params(d)
        assert str(got.value) == str(want.value)


def test_hmc_is_not_ported_yet():
    # HMC runs over one dimension (tests/test_torch_hmc.py), d dimensions
    # (tests/test_torch_hmc_nd.py) and a ladder
    # (tests/test_torch_hmc_tempering.py): nothing of it is left to port.
    assert type(tm.RandomWalk.from_reference(jmc.HMC(step_size=0.5))) is tm.HMC
    nd = _call(fns=[lambda x, y: x], target=[_T, _T], proposal=_hmc())
    pt = _call(proposal=_hmc(), temperatures=[1.0, 2.0])
    assert np.isfinite(nd.values).all() and np.isfinite(pt.values).all()


# -- the plain version against the interpret-mode JAX kernel -----------------


@pytest.mark.parametrize("case", list(CASES))
def test_mcmc_reference_matches_jax_kernel(case):
    x_port, values, acc, se = _port_run(case, N_CHAINS, N_STEPS, N_BURNIN)
    j_values, j_acc, x_jax, _ = _jax_run(
        case, N_CHAINS, N_STEPS, N_BURNIN, with_state=True
    )
    _assert_chains_agree(x_port, x_jax)
    assert np.all(np.isfinite(values))
    if CASES[case][4]:
        # Error-bar runs report chain-mean sums: the JAX error-bar kernel.
        j_values, j_acc, j_se = _jax_run(case, N_CHAINS, N_STEPS, N_BURNIN)
        assert se is not None and np.all(se.numpy() > 0)
        np.testing.assert_allclose(se.numpy(), j_se, rtol=1e-3)
    else:
        assert se is None
    np.testing.assert_allclose(values, j_values, rtol=0, atol=1e-5)
    assert abs(acc - float(j_acc)) <= 1e-4


def test_chains_of_later_programs_match_jax_kernel():
    # 9000 chains plan 2 programs of 8192: the second program's stream
    # is seeded with program id 1.
    x_port, values, acc, _ = _port_run("random-walk", 9000, 4, 2)
    j_values, j_acc, x_jax, _ = _jax_run(
        "random-walk", 9000, 4, 2, with_state=True
    )
    assert x_port.shape == (16_384,)
    _assert_chains_agree(x_port, x_jax)
    np.testing.assert_allclose(values, j_values, rtol=0, atol=1e-5)
    assert abs(acc - float(j_acc)) <= 1e-4


# -- the public API -----------------------------------------------------------


@pytest.mark.parametrize(
    "make_proposal",
    [
        lambda pkg: pkg.Distribution.normal(0.0, 3.0),
        lambda pkg: pkg.RandomWalk(adapt=True),
    ],
    ids=["independence", "adaptive-walk"],
)
def test_integrate_mcmc_matches_jax_pallas_backend(make_proposal):
    kw = dict(n_steps=N_STEPS, n_chains=1000, n_burnin=N_BURNIN, seed=7,
              return_stderr=True)
    want = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
        FNS, jmc.Distribution.normal(0.5, 1.5), make_proposal(jmc), **kw
    )
    got = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
        FNS, tm.Distribution.normal(0.5, 1.5), make_proposal(tm), **kw
    )
    assert got.values.dtype == np.float64 and got.values.shape == (4,)
    assert got.n_samples == want.n_samples == 1000 * N_STEPS
    assert got.n_functions == 4 and isinstance(got.acceptance_rate, float)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-5)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= 1e-4
    np.testing.assert_allclose(got.stderr, want.stderr, rtol=1e-3)


def test_module_function_and_defaults():
    r = tm.integrate_mcmc(
        [lambda x: x * x], tm.Distribution.normal(0.0, 1.0),
        tm.Distribution.normal(0.0, 2.0), n_steps=200, n_burnin=50,
        device="cpu",
    )
    assert r.n_samples == 1024 * 200 and r.stderr is None
    assert r.chain_state is None and r.samples is None
    assert abs(r.values[0] - 1.0) < 0.1
    assert 0.4 < r.acceptance_rate < 0.8


@pytest.mark.parametrize(
    "target,proposal,mean",
    [
        (("normal", 0.0, 1.0), ("walk",), 1.0),
        (("exponential", 2.0), ("exponential", 1.0), 0.5),
        (("uniform", -1.0, 2.0), ("normal", 0.5, 2.0), 1.0),
    ],
    ids=["walk-normal", "exponential", "uniform"],
)
def test_estimates_within_six_stderr(target, proposal, mean):
    # E[x^2] of N(0,1) is 1; E[x^2] of Exp(2) is 0.5; of U(-1,2) it is 1.
    t = getattr(tm.Distribution, target[0])(*target[1:])
    if proposal[0] == "walk":
        p = tm.RandomWalk(adapt=True)
    else:
        p = getattr(tm.Distribution, proposal[0])(*proposal[1:])
    r = tm.integrate_mcmc(
        [lambda x: x * x], t, p, n_steps=400, n_chains=4096, n_burnin=100,
        seed=11, return_stderr=True, device="cpu",
    )
    assert abs(r.values[0] - mean) <= 6.0 * r.stderr[0]


def test_seeds():
    integ = tm.MonteCarloIntegrator(device="cpu")
    d, q = tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(0.0, 2.0)
    kw = dict(n_steps=20, n_burnin=5)
    r1 = integ.integrate_mcmc([lambda x: x * x], d, q, seed=7, **kw)
    r2 = integ.integrate_mcmc([lambda x: x * x], d, q, seed=7, **kw)
    r3 = integ.integrate_mcmc([lambda x: x * x], d, q, seed=8, **kw)
    np.testing.assert_array_equal(r1.values, r2.values)
    assert r1.values[0] != r3.values[0]
    with pytest.raises(OverflowError):
        integ.integrate_mcmc([lambda x: x], d, q, seed=-1, **kw)


def test_target_threads_overrides_n_chains():
    d, q = tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(0.0, 2.0)
    kw = dict(n_steps=10, n_burnin=2, seed=3)
    a = tm.integrate_mcmc([lambda x: x], d, q, n_chains=1024, device="cpu", **kw)
    b = tm.integrate_mcmc(
        [lambda x: x], d, q, n_chains=5, target_threads=1024, device="cpu",
        **kw,
    )
    np.testing.assert_array_equal(a.values, b.values)
    assert b.n_samples == 5 * 10


def _make_fns(c):
    return [lambda x: x + c]


def test_program_cache_hits_for_fresh_identical_lambdas(program_cache):
    d, q = tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(0.0, 2.0)
    kw = dict(n_steps=5, n_burnin=1, device="cpu")
    tm.integrate_mcmc(_make_fns(0.25), d, q, **kw)
    size = len(program_cache._store)
    tm.integrate_mcmc(_make_fns(0.25), d, q, **kw)
    assert len(program_cache._store) == size
    tm.integrate_mcmc(_make_fns(1.25), d, q, **kw)
    assert len(program_cache._store) == size + 1


# -- what the slice does not take ---------------------------------------------

_T = tm.Distribution.normal(0.0, 1.0)
_Q = tm.Distribution.normal(0.0, 2.0)
def _hmc():
    """An HMC proposal."""
    return tm.HMC(step_size=0.5, init_range=(-4.0, 4.0))


def _call(**kwargs):
    fns = kwargs.pop("fns", [lambda x: x])
    target = kwargs.pop("target", _T)
    proposal = kwargs.pop("proposal", _Q)
    return tm.integrate_mcmc(
        fns, target, proposal, n_steps=10, n_burnin=2, device="cpu", **kwargs
    )


def _wide_values(k):
    """A check of a wide set's values: k functions x + c (1-D) or x + c
    of (x, y), in passes over one set of chains, so each value less the
    first is c (every row of a batch)."""
    def check(values):
        values = np.asarray(values)
        assert values.shape[-1] == k and np.all(np.isfinite(values))
        shift = values - values[..., :1]
        np.testing.assert_allclose(shift, np.broadcast_to(
            np.arange(float(k)), shift.shape), atol=1e-3)

    return check


# case: the call, and the ROADMAP item its error names; or, for the sets
# over more than 127 (126) functions, which run in passes since they were
# ported (api/passes.py), the check of the values the call returns.
NOT_PORTED = {
    # The 1-D, nd and tempered handles run
    # (tests/test_torch_serving_mcmc*.py, test_torch_serving_tempering.py),
    # over more than 127 functions too.
    "compile_mcmc": (
        lambda: tm.MonteCarloIntegrator(device="cpu").compile_mcmc(
            [(lambda c: lambda x, y: x + c)(float(c)) for c in range(128)],
            [_T, _T], [_Q, _Q], seed_batch=4, n_steps=10, n_burnin=2,
        )([1, 2, 3, 4])[0],
        _wide_values(128),
    ),
    "128-functions": (
        lambda: _call(fns=[(lambda c: lambda x: x + c)(float(c))
                           for c in range(256)]).values,
        _wide_values(256),
    ),
    # Extended families run (tests/test_torch_families_kernels.py), and
    # so do their seed batches, tempered too, over more than 126
    # functions as well.
    "extended-family": (
        lambda: tm.MonteCarloIntegrator(device="cpu").compile_mcmc(
            [(lambda c: lambda x: x + c)(float(c)) for c in range(127)],
            tm.Distribution.cauchy(0.0, 1.0), _Q, seed_batch=4,
            temperatures=[1.0, 2.0], n_steps=10, n_burnin=2,
        )([1, 2, 3, 4])[0],
        _wide_values(127),
    ),
    "mesh": (lambda: tm.integrate_mcmc([lambda x: x], _T, _Q, mesh="auto"),
             "item 12"),
}


@pytest.mark.parametrize("case", list(NOT_PORTED))
def test_out_of_scope_options_raise(case):
    call, item = NOT_PORTED[case]
    if callable(item):
        item(call())
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, queue 1 {item}"):
        call()


def test_extended_families_run_in_the_kernel_wrapper():
    fns = [to_torch(tm.trace_function(lambda x: x))]
    cfg = McmcConfig(Mode.INDEPENDENCE, DistKind.CAUCHY, _N, 4, 0)
    params = torch.tensor([0.0, 1.0, 0, 0, 0.0, 1.0])
    out = mcmc_reference(fns, cfg, params, 1, plan_mcmc_grid(256))
    assert torch.all(torch.isfinite(out.rows)) and out.x_final.shape == (1024,)


ARG_ERRORS = [
    {"functions": []},
    {"n_steps": 0},
    {"n_chains": 0},
    {"n_burnin": -1},
    {"return_stderr": True, "return_state": True},
    {"return_diagnostics": True, "return_state": True},
    {"return_samples": 0},
    {"return_samples": 3, "return_state": True},
    {"proposal": "adapt", "n_burnin": 0},
]


@pytest.mark.parametrize("kwargs", ARG_ERRORS, ids=lambda k: "-".join(k))
def test_argument_errors_match_jax(kwargs):
    def call(pkg, integ):
        kw = dict(n_steps=10, n_chains=256, n_burnin=2, seed=1)
        kw.update(kwargs)
        fns = kw.pop("functions", [lambda x: x])
        proposal = kw.pop("proposal", None)
        proposal = (
            pkg.RandomWalk(adapt=True) if proposal == "adapt"
            else pkg.Distribution.normal(0.0, 2.0)
        )
        return integ.integrate_mcmc(
            fns, pkg.Distribution.normal(0.0, 1.0), proposal, **kw
        )

    with pytest.raises(ValueError) as want:
        call(jmc, jmc.MonteCarloIntegrator(backend="pallas"))
    with pytest.raises(ValueError) as got:
        call(tm, tm.MonteCarloIntegrator(device="cpu"))
    assert str(got.value) == str(want.value)


def test_missing_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.integrate_mcmc([lambda x: x], _T, _Q, n_steps=10)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    program = McmcProgram((tm.trace_function(lambda x: x * x),))
    cfg = McmcConfig(Mode.RANDOM_WALK, _N, _N, 8, 2, with_stderr=True)
    grid = plan_mcmc_grid(1024)
    params = torch.tensor(_WALK + [0.0, 1.0])
    before = mcmc_cuda.launches
    got = mcmc_cuda(program, cfg, params, 5, grid)
    want = mcmc_reference(program.torch_fns, cfg, params, 5, grid)
    assert torch.equal(got.rows, want.rows)
    assert torch.equal(got.x_final, want.x_final)
    assert got.rows.shape == (1024 // 32, 3, 2)
    assert mcmc_cuda.launches == before  # no kernel ran
    with pytest.raises(ValueError):
        mcmc_cuda(program, cfg, params.double(), 5, grid)
    with pytest.raises(ValueError, match="no MCMC kernel"):
        mcmc_cuda(program, cfg, params.to("meta"), 5, grid)


def test_runs_with_jax_blocked(tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(
        "import sys\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "import tpu_montecarlo_torch as tm\n"
        "import tpu_montecarlo_torch.ops.integrate_nd_kernel\n"
        "import tpu_montecarlo_torch.ops.qmc\n"
        "r = tm.integrate_mcmc([lambda x: x * x], tm.Distribution.normal(0, 1),\n"
        "                      tm.RandomWalk(adapt=True), n_steps=50,\n"
        "                      n_burnin=20, device='cpu', return_stderr=True)\n"
        "assert 'tpu_montecarlo' not in sys.modules\n"
        "print(r.values[0], r.stderr[0])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(script)], check=True, cwd=tmp_path, env=env,
        capture_output=True, text=True,
    )
    value, stderr = map(float, out.stdout.split())
    assert abs(value - 1.0) < 0.2 and stderr > 0
