"""The port's multi-dimensional MCMC slice against the JAX package.

The port's plain PyTorch version runs, chain for chain, the chains of the
JAX kernel ``build_mcmc_nd_pallas`` in interpret mode (its ``CounterRng``
stream, seeded per (seed ^ 0x27D4EB2F, program), dimension j under tag
j), reached through ``MonteCarloIntegrator(backend="pallas")``.  That
kernel keeps no state output; its final states are the last thinned draw
of ``return_samples=n_steps``, which the kernel writes after every step.
The tests hold:

* the nd stream's uniforms bit-equal to the JAX ``CounterRng``;
* per chain, on integrand and target sets without trigonometry (the JAX
  kernel evaluates ``sin`` and ``cos`` by its own polynomials): no final
  state more than 1e-4 (relative) from the JAX kernel's.  The walks sum
  steps whose last bits differ with ``erfinv``'s (torch's and XLA's
  differ by up to 91 ulp), so states drift by ulps, not more;
* the means within rel 1e-5 + abs 1e-6 (float32 summation order);
* the acceptance rates within 1e-7 (the same count; float32 division);
* the error bars within rel 1e-3 (blocks of 32 chains against programs
  of 1,024 as the unit of Chan's recombination).

The JAX package's default route off the TPU is its XLA sweep, keyed on
``jax.random``: there the port agrees only statistically, within 6
combined standard errors (c9d, c9e, c10b at small size).  The CUDA kernel
is held against the plain version in ``test_torch_cuda.py``.
"""

import ctypes
import os
import shutil
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
from tpu_montecarlo.api.batching import _target_arity as j_target_arity
from tpu_montecarlo.ops import integrate_pallas as jpl
from tpu_montecarlo.ops.mcmc_nd_pallas import _ND_STREAM_MIX

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import mcmc_nd as api_nd
from tpu_montecarlo_torch.ops import integrate_kernel as tk
from tpu_montecarlo_torch.ops.lower import (
    cuda_source,
    cuda_target_source,
    to_torch,
)
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    Mode,
    mcmc_cuda,
    plan_chains,
    plan_mcmc_grid,
)
from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
    ND_SEED_MIX,
    McmcNdConfig,
    McmcNdProgram,
    mcmc_nd_cuda,
    mcmc_nd_reference,
    nd_seed_word,
)
from tpu_montecarlo_torch.sampling import DistKind

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "tpu_montecarlo_torch" / "csrc"

N_CHAINS, N_STEPS, N_BURNIN = 1024, 200, 50
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-6
ACCEPT_ATOL = 1e-7
STDERR_RTOL = 1e-3
SPLIT_RTOL = 1e-4


def _c9e_target():
    """c9e's joint log density in ``benchmarks/run_all.py``'s form: a
    bivariate normal with rho = 0.8, its constants read from the
    closure."""
    rho9 = 0.8
    c9c = 1.0 / (2.0 * (1.0 - rho9 * rho9))
    return lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y)


def _normal_target():
    """A 1-D joint log density: N(0, 1) up to its constant."""
    return lambda x: -0.5 * x * x


def _d3_target():
    """A joint log density of three arguments: a Gaussian with x-y and
    y-z coupling, and a heavier quartic tail in z."""
    return lambda x, y, z: -0.5 * (x * x + y * y - x * y + z * z) - 0.05 * z * z * z * z


FNS2 = [
    lambda x, y: x * y,
    lambda x, y: x * x + y * y,
    lambda x, y: (x > 1.0) * y,
]
FNS1 = [lambda x: x, lambda x: x * x]
FNS3 = [lambda x, y, z: x * y + z, lambda x, y, z: abs(x - z) * y]
WALK_RANGE = (-4.0, 4.0)


def _dist(pkg, spec):
    name, *args = spec
    return getattr(pkg.Distribution, name)(*args)


def _target(pkg, target):
    if callable(target):
        return target()
    return [_dist(pkg, s) for s in target]


def _proposal(pkg, proposal):
    if isinstance(proposal, dict):
        return pkg.RandomWalk(**proposal)
    if isinstance(proposal, tuple) and isinstance(proposal[0], str):
        return _dist(pkg, proposal)
    return [_dist(pkg, s) for s in proposal]


# id: (fns, target, proposal, return_stderr).  A target is a list of
# per-dimension specs or a maker of the joint log density; a proposal a
# list of specs, one spec, or RandomWalk's keyword arguments.
CASES = {
    "independence-product": (
        FNS2, [("normal", 0.5, 1.5), ("exponential", 1.5)],
        [("normal", 0.0, 3.0), ("exponential", 1.0)], False,
    ),
    "independence-joint": (
        FNS2, _c9e_target, [("normal", 0.0, 2.0)] * 2, False,
    ),
    "walk-joint": (
        FNS2, _c9e_target,
        dict(step_size=1.0, target_accept=0.234, init_range=WALK_RANGE), False,
    ),
    "adaptive-walk-joint": (
        FNS2, _c9e_target,
        dict(step_size=1.0, adapt=True, target_accept=0.234,
             init_range=WALK_RANGE), False,
    ),
    "independence-joint-stderr": (
        FNS2, _c9e_target, [("normal", 0.0, 2.0)] * 2, True,
    ),
    "adaptive-walk-product-stderr": (
        FNS2, [("uniform", -1.0, 2.0), ("normal", 0.0, 1.0)],
        dict(step_size=[0.5, 1.5], adapt=True), True,
    ),
    "d1-joint-stderr": (
        FNS1, _normal_target, ("normal", 0.0, 2.0), True,
    ),
    "d3-walk-joint": (
        FNS3, _d3_target,
        dict(step_size=[0.9, 0.8, 0.7],
             init_range=[(-3.0, 3.0), (-2.0, 2.0), (-1.0, 1.0)]), False,
    ),
    "d3-independence-product-stderr": (
        FNS3,
        [("normal", 0.5, 1.5), ("uniform", -1.0, 2.0), ("exponential", 2.0)],
        [("normal", 0.0, 3.0), ("uniform", -1.0, 2.0), ("exponential", 1.0)],
        True,
    ),
}


def _jax_run(case, n_chains=N_CHAINS, n_steps=N_STEPS, n_burnin=N_BURNIN,
             seed=42):
    """The interpret-mode JAX kernel through its public API: the result
    and the final states, (chains, d)."""
    fns, target, proposal, stderr = CASES[case]
    r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
        fns, _target(jmc, target), _proposal(jmc, proposal),
        n_steps=n_steps, n_chains=n_chains, n_burnin=n_burnin, seed=seed,
        return_stderr=stderr, return_samples=n_steps,
    )
    return r, np.asarray(r.samples[-1])


def _port_run(case, monkeypatch, n_chains=N_CHAINS, n_steps=N_STEPS,
              n_burnin=N_BURNIN, seed=42):
    """The port's public path on the CPU: the result and the final states
    of the run (caught at the kernel wrapper), (chains, d)."""
    fns, target, proposal, stderr = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_nd_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_nd, "mcmc_nd_cuda", spy)
    r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
        fns, _target(tm, target), _proposal(tm, proposal),
        n_steps=n_steps, n_chains=n_chains, n_burnin=n_burnin, seed=seed,
        return_stderr=stderr,
    )
    assert len(outs) == 1
    return r, outs[0].x_final.numpy().T


def _assert_agree(got, x_port, want, x_jax, stderr):
    assert x_port.shape == x_jax.shape
    split = np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))
    assert not split.any(), f"{split.any(axis=1).sum()} chains split"
    assert got.values.dtype == np.float64 and np.all(np.isfinite(got.values))
    np.testing.assert_allclose(
        got.values, np.asarray(want.values, np.float64),
        rtol=VALUE_RTOL, atol=VALUE_ATOL,
    )
    assert abs(got.acceptance_rate - want.acceptance_rate) <= ACCEPT_ATOL
    if stderr:
        assert np.all(got.stderr > 0)
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)
    else:
        assert got.stderr is None


# -- the nd stream, bit for bit ----------------------------------------------


def test_nd_seed_mix_is_the_jax_kernels():
    assert ND_SEED_MIX == _ND_STREAM_MIX
    for seed in (0, 42, 2**31 + 5, 2**32 - 1):
        assert nd_seed_word(seed) == (seed ^ _ND_STREAM_MIX)
    with pytest.raises(OverflowError):
        nd_seed_word(-1)


@pytest.mark.parametrize("form", ["open01", "halfopen01"])
@pytest.mark.parametrize("seed", [42, 2**31 + 5])
def test_nd_stream_uniforms_bit_equal(form, seed):
    # The JAX kernel seeds with the int32 seed xor the mix
    # (mcmc_nd_pallas.py:359-362) and draws dimension j under tag j.
    shape = (8, 128)
    jfn = getattr(jpl, f"_uniform_{form}")
    tfn = getattr(tk, f"uniform_{form}")
    seed_i32 = np.array(seed, np.uint32).view(np.int32)
    for pid in (0, 3):
        jrng = jpl.CounterRng()
        jrng.seed(jnp.int32(seed_i32) ^ _ND_STREAM_MIX, jnp.int32(pid))
        trng = tk.CounterRng(nd_seed_word(seed), pid)
        for i in (0, 7, 999):
            for counter in {0, 3 * i + 1, 3 * i + 2}:
                for tag in range(4):
                    want = np.asarray(jfn(jrng, shape, jnp.int32(counter), tag))
                    got = tfn(trng, shape, counter, tag).numpy()
                    np.testing.assert_array_equal(got, want)


# -- host-side ports: pack_params_nd, _target_arity, the argument errors ------

PACK_TARGETS = [
    [("normal", 0.5, 1.5), ("exponential", 2.0), ("uniform", -1.0, 2.0)],
    None,
]
PACK_KWARGS = [
    {"init_range": (-4.0, 4.0)},
    {"step_size": [0.5, 1.0, 2.0], "adapt": True, "target_accept": 0.234,
     "init_range": [(0.0, 1.0), (-2.0, 2.0), (1.0, 3.0)]},
    {},
]


@pytest.mark.parametrize("kwargs", PACK_KWARGS, ids=["range", "per-dim", "default"])
@pytest.mark.parametrize("targets", PACK_TARGETS, ids=["product", "joint"])
def test_pack_params_nd_matches_jax(kwargs, targets):
    d = 3

    def pack(pkg):
        ts = None if targets is None else [_dist(pkg, s) for s in targets]
        return pkg.RandomWalk(**kwargs).pack_params_nd(ts, d)

    if targets is None and "init_range" not in kwargs:
        with pytest.raises(ValueError) as want:
            pack(jmc)
        with pytest.raises(ValueError) as got:
            pack(tm)
        assert str(got.value) == str(want.value)
        return
    got = pack(tm)
    assert got.dtype == np.float32 and got.shape == (d, 4)
    np.testing.assert_array_equal(got, pack(jmc))


@pytest.mark.parametrize(
    "kwargs",
    [{"step_size": [1.0, 2.0]}, {"init_range": [(0, 1), (1, 2)]}],
    ids=["steps", "ranges"],
)
def test_pack_params_nd_wrong_dimension_raises_as_jax(kwargs):
    targets = [("normal", 0.0, 1.0)] * 3
    with pytest.raises(ValueError) as want:
        jmc.RandomWalk(**kwargs).pack_params_nd(
            [_dist(jmc, s) for s in targets], 3
        )
    with pytest.raises(ValueError) as got:
        tm.RandomWalk(**kwargs).pack_params_nd(
            [_dist(tm, s) for s in targets], 3
        )
    assert str(got.value) == str(want.value)


def _three(a, b, c=1.0, *, d=2.0):
    return a


def _star(*xs):
    return xs[0]


@pytest.mark.parametrize(
    "fn",
    [lambda x: x, lambda x, y: x, _three, lambda a, b, /, c: a],
    ids=["one", "two", "defaults-and-keyword-only", "positional-only"],
)
def test_target_arity_matches_jax(fn):
    assert api_nd._target_arity(fn) == j_target_arity(fn)


@pytest.mark.parametrize("fn", [_star, max], ids=["star-args", "no-signature"])
def test_target_arity_errors_match_jax(fn):
    with pytest.raises(TypeError) as want:
        j_target_arity(fn)
    with pytest.raises(TypeError) as got:
        api_nd._target_arity(fn)
    assert str(got.value) == str(want.value)


_N01 = ("normal", 0.0, 1.0)
_N02 = ("normal", 0.0, 2.0)
ARG_ERRORS = {
    "proposal-type": (TypeError, [_N01, _N01], 3),
    "empty-proposals": (TypeError, [_N01, _N01], []),
    "target-length": (TypeError, [_N01, _N01, _N01], [_N02, _N02]),
    "one-target-two-proposals": (TypeError, _N01, [_N02, _N02]),
    "target-type": (TypeError, 5, [_N02, _N02]),
    "joint-walk-without-range": (ValueError, "joint", {}),
}


@pytest.mark.parametrize("case", list(ARG_ERRORS))
def test_argument_errors_match_jax(case):
    error, target, proposal = ARG_ERRORS[case]

    def call(pkg, integ):
        if target == "joint":
            t = _c9e_target()
        elif isinstance(target, list):
            t = [_dist(pkg, s) for s in target]
        elif isinstance(target, tuple):
            t = _dist(pkg, target)
        else:
            t = target
        if isinstance(proposal, dict):
            p = pkg.RandomWalk(**proposal)
        elif isinstance(proposal, list):
            p = [_dist(pkg, s) for s in proposal]
        else:
            p = proposal
        return integ.integrate_mcmc(
            [lambda x, y: x], t, p, n_steps=10, n_chains=256, n_burnin=2
        )

    with pytest.raises(error) as want:
        call(jmc, jmc.MonteCarloIntegrator(backend="pallas"))
    with pytest.raises(error) as got:
        call(tm, tm.MonteCarloIntegrator(device="cpu"))
    assert str(got.value) == str(want.value)


def test_config_and_program_validation():
    n = DistKind.NORMAL
    with pytest.raises(ValueError, match="one family per dimension"):
        McmcNdConfig(Mode.INDEPENDENCE, 2, (n,), None, 10, 2)
    with pytest.raises(ValueError, match="a walk none"):
        McmcNdConfig(Mode.RANDOM_WALK, 2, (n, n), None, 10, 2)
    with pytest.raises(ValueError, match="product target"):
        McmcNdConfig(Mode.RANDOM_WALK, 2, (), (n,), 10, 2)
    # The extended families are families like the others.
    assert McmcNdConfig(Mode.INDEPENDENCE, 1, (DistKind.CAUCHY,), None, 10,
                        2).prop_kinds == (DistKind.CAUCHY,)
    cfg = McmcNdConfig(Mode.RANDOM_WALK, 2, (), None, 10, 2)
    f2 = (tm.trace_function(lambda x, y: x, 2),)
    with pytest.raises(ValueError, match="joint target needs"):
        McmcNdProgram(f2, cfg)
    with pytest.raises(ValueError, match="3 arguments"):
        McmcNdProgram(
            (tm.trace_function(lambda x, y: x, 2),),
            McmcNdConfig(Mode.RANDOM_WALK, 3, (), None, 10, 2),
            tm.trace_function(lambda x, y, z: x, 3),
        )


# -- the plain version against the interpret-mode JAX kernel ----------------


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(case, monkeypatch):
    want, x_jax = _jax_run(case)
    got, x_port = _port_run(case, monkeypatch)
    assert got.n_samples == want.n_samples == N_CHAINS * N_STEPS
    assert got.n_functions == len(CASES[case][0])
    _assert_agree(got, x_port, want, x_jax, CASES[case][3])


def test_chains_of_a_later_program_match_jax_kernel(monkeypatch):
    # 16,384 chains plan 2 programs of 8,192: the second program's stream
    # is seeded with program id 1.
    kw = dict(n_chains=16_384, n_steps=25, n_burnin=5, seed=7)
    assert plan_mcmc_grid(plan_chains(16_384, None)).programs == 2
    want, x_jax = _jax_run("adaptive-walk-joint", **kw)
    got, x_port = _port_run("adaptive-walk-joint", monkeypatch, **kw)
    assert x_port.shape == (16_384, 2)
    _assert_agree(got, x_port, want, x_jax, False)


# -- the benchmark's nd MCMC configurations against the JAX default route ----

BENCH_CELLS = {
    "c9d": ([lambda x, y: x * x + y * y], [_N01, _N01], [_N02, _N02], 2.0),
    "c9e": ([lambda x, y: x * y], _c9e_target, [_N02, _N02], 0.8),
    "c10b": (
        [lambda x, y: x * y], _c9e_target,
        dict(step_size=1.0, target_accept=0.234, init_range=(-4.0, 4.0)), 0.8,
    ),
}


@pytest.mark.parametrize("cell", list(BENCH_CELLS))
def test_benchmark_cells_agree_with_jax_default_route(cell):
    # The JAX package's default CPU route is its XLA sweep (jax.random):
    # the two agree within 6 combined standard errors, and each is within
    # 6 of its own of the closed form.
    fns, target, proposal, exact = BENCH_CELLS[cell]
    kw = dict(n_steps=400, n_chains=2048, n_burnin=100, seed=42,
              return_stderr=True)
    want = jmc.MonteCarloIntegrator().integrate_mcmc(
        fns, _target(jmc, target), _proposal(jmc, proposal), **kw
    )
    got = tm.integrate_mcmc(
        fns, _target(tm, target), _proposal(tm, proposal), device="cpu", **kw
    )
    v, se = float(got.values[0]), float(got.stderr[0])
    wv, wse = float(want.values[0]), float(want.stderr[0])
    assert abs(v - wv) <= 6.0 * np.hypot(se, wse)
    assert abs(v - exact) <= 6.0 * se and abs(wv - exact) <= 6.0 * wse
    assert 0.0 < got.acceptance_rate < 1.0


# -- the public path --------------------------------------------------------


def test_one_dimensional_product_takes_the_1d_path():
    # A d = 1 Distribution target keeps the 1-D kernel (api/mcmc_nd.py:438).
    kw = dict(n_steps=50, n_chains=1024, n_burnin=10, seed=3, device="cpu")
    t, q = tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(0.0, 2.0)
    before = mcmc_nd_cuda.launches, mcmc_cuda.launches
    a = tm.integrate_mcmc([lambda x: x * x], [t], [q], **kw)
    b = tm.integrate_mcmc([lambda x: x * x], t, q, **kw)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.acceptance_rate == b.acceptance_rate
    assert (mcmc_nd_cuda.launches, mcmc_cuda.launches) == before  # CPU


def test_cache_keys_on_target_and_families(program_cache):
    kw = dict(n_steps=5, n_chains=256, n_burnin=1, device="cpu")
    n2 = [tm.Distribution.normal(0.0, 2.0)] * 2
    f = FNS2[:1]
    tm.integrate_mcmc(f, _c9e_target(), n2, **kw)
    size = len(program_cache._store)
    tm.integrate_mcmc(f, _c9e_target(), n2, **kw)  # a fresh, equal target
    assert len(program_cache._store) == size
    tm.integrate_mcmc(f, lambda x, y: -x * x - y * y, n2, **kw)
    assert len(program_cache._store) == size + 1
    tm.integrate_mcmc(f, _c9e_target(), [tm.Distribution.uniform(-4.0, 4.0)] * 2, **kw)
    assert len(program_cache._store) == size + 2


def test_out_of_scope_options_name_their_roadmap_items():
    integ = tm.MonteCarloIntegrator(device="cpu")
    f2 = [lambda x, y: x * y]
    n = tm.Distribution.normal(0.0, 1.0)
    heavy = tm.Distribution.student_t(5.0)  # a knot-exact, heavy-tailed table
    wide = [(lambda c: lambda x, y: x + c)(float(c)) for c in range(128)]
    kw = dict(n_steps=10, n_burnin=2)

    def run(fns=f2, target=(n, n), proposal=(n, n), **extra):
        return integ.integrate_mcmc(fns, target, proposal, **kw, **extra)

    cases = {
        r"item 3 ": lambda: integ.integrate_mcmc(
            f2, "fn f(x: f32, y: f32) -> f32 { return -x * x; }",
            tm.RandomWalk(init_range=(-1.0, 1.0)), **kw),
    }
    for item, case in cases.items():
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1 " + item):
            case()
    # Item 8.9, which raised here before: the heavy-tailed proposal
    # dimension runs on the knots route (its CDF knots, its full log table).
    r = run(proposal=(n, heavy))
    assert r.values.shape == (1,) and np.all(np.isfinite(r.values))
    assert 0.0 < r.acceptance_rate <= 1.0
    # Item 8.8, which raised here before: 128 functions run in two passes
    # of 64 over the same chains (api/passes.py), E[x + c] - E[x] = c.
    for values in (
            integ.compile_mcmc(wide, [n, n], [n, n], seed_batch=2,
                               **kw)([1, 2])[0].numpy(),
            run(fns=wide).values):
        assert values.shape[-1] == 128
        shift = values - values[..., :1]
        np.testing.assert_allclose(shift, np.broadcast_to(
            np.arange(128.0), shift.shape), atol=1e-3)


def test_missing_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    n = tm.Distribution.normal(0.0, 2.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.integrate_mcmc([lambda x, y: x * y], _c9e_target(), [n, n], n_steps=10)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    cfg = McmcNdConfig(Mode.ADAPTIVE, 2, (), None, 8, 2, with_stderr=True)
    program = McmcNdProgram(
        tuple(tm.trace_function(f, 2) for f in FNS2), cfg,
        tm.trace_function(_c9e_target(), 2),
    )
    grid = plan_mcmc_grid(1024)
    params = torch.tensor([[0.5, -4.0, 4.0, 0.234, 0.0, 0.0]] * 2)
    before = mcmc_nd_cuda.launches, mcmc_nd_cuda.pilot_launches
    got = mcmc_nd_cuda(program, cfg, params, 5, grid)
    want = mcmc_nd_reference(
        program.torch_fns, program.torch_target, cfg, params, 5, grid
    )
    assert torch.equal(got.rows, want.rows)
    assert torch.equal(got.x_final, want.x_final)
    assert got.rows.shape == (1024 // 32, 3, len(FNS2) + 1)
    assert got.x_final.shape == (2, 1024)
    assert (mcmc_nd_cuda.launches, mcmc_nd_cuda.pilot_launches) == before
    with pytest.raises(ValueError, match="float32"):
        mcmc_nd_cuda(program, cfg, params.double(), 5, grid)
    with pytest.raises(ValueError, match=r"\(2, 6\)"):
        mcmc_nd_cuda(program, cfg, params[:, :4].contiguous(), 5, grid)
    with pytest.raises(ValueError, match="built for"):
        mcmc_nd_cuda(
            program, McmcNdConfig(Mode.RANDOM_WALK, 2, (), None, 8, 2),
            params, 5, grid,
        )
    with pytest.raises(ValueError, match="no nd MCMC kernel"):
        mcmc_nd_cuda(program, cfg, params.to("meta"), 5, grid)


# -- the lowering the kernel includes -----------------------------------------

_SHIM = r"""
#include "integrand_math.cuh"
#include "integrands.inc"
extern "C" int tmc_d() { return TMC_D; }
extern "C" void tmc_eval(const float* pts, long n, float* vals, float* logp) {
  for (long i = 0; i < n; ++i) {
    tmc_values_nd(pts + i * TMC_D, vals + i * TMC_K);
    logp[i] = tmc_target_logpdf(pts + i * TMC_D);
  }
}
"""


@pytest.mark.parametrize(
    "fns,target,d",
    [(FNS1, _normal_target, 1), (FNS2, _c9e_target, 2), (FNS3, _d3_target, 3)],
    ids=["d1", "c9e", "d3"],
)
def test_pointer_lowering_and_joint_target_match_torch(tmp_path, fns, target, d):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    traced = [tm.trace_function(f, d) for f in fns]
    t = tm.trace_function(target(), d)
    src = cuda_source(traced, pointer=True) + cuda_target_source(t)
    assert f"#define TMC_D {d}" in src
    assert "static __device__ inline float f_0(const float* x) {" in src
    assert "static __device__ inline float tmc_target_logpdf(const float* x) {" in src
    (tmp_path / "integrands.inc").write_text(src)
    (tmp_path / "shim.cpp").write_text(_SHIM)
    so = tmp_path / "libnd.so"
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-D__device__=", "-I", str(CSRC), "-I", str(tmp_path),
         str(tmp_path / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.tmc_eval.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.tmc_eval.restype = None
    assert lib.tmc_d() == d
    rs = np.random.default_rng(d)
    pts = np.ascontiguousarray(rs.normal(0.0, 2.0, (4096, d)).astype(np.float32))
    vals = np.zeros((4096, len(fns)), np.float32)
    logp = np.zeros(4096, np.float32)
    lib.tmc_eval(pts.ctypes.data, 4096, vals.ctypes.data, logp.ctypes.data)
    cols = [torch.from_numpy(pts[:, j].copy()) for j in range(d)]
    want = np.stack([to_torch(f)(*cols).to(torch.float32).numpy() for f in traced], 1)
    np.testing.assert_array_equal(vals, want)
    np.testing.assert_array_equal(logp, to_torch(t)(*cols).numpy())


def test_runs_with_jax_blocked(tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(
        "import sys\n"
        "sys.modules['jax'] = None  # any import of jax now fails\n"
        "import tpu_montecarlo_torch as tm\n"
        "import tpu_montecarlo_torch.ops.mcmc_nd_kernel\n"
        "rho9 = 0.8\n"
        "c9c = 1.0 / (2.0 * (1.0 - rho9 * rho9))\n"
        "n2 = tm.Distribution.normal(0.0, 2.0)\n"
        "for p in ([n2, n2], tm.RandomWalk(adapt=True, target_accept=0.234,\n"
        "                                  init_range=(-4.0, 4.0))):\n"
        "    r = tm.integrate_mcmc(\n"
        "        [lambda x, y: x * y],\n"
        "        lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y),\n"
        "        p, n_steps=200, n_chains=1024, n_burnin=50,\n"
        "        return_stderr=True, device='cpu')\n"
        "    print(r.values[0], r.stderr[0])\n"
        "assert 'tpu_montecarlo' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(script)], check=True, cwd=tmp_path, env=env,
        capture_output=True, text=True,
    )
    for line in out.stdout.splitlines():
        value, stderr = map(float, line.split())
        assert abs(value - 0.8) < 6 * stderr and 0 < stderr < 0.05
