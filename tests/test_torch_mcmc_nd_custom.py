"""CUSTOM dimensions in the port's nd MCMC kernel against the JAX package.

The plain version of the nd kernel runs the chains of the interpret-mode
JAX kernel ``build_mcmc_nd_pallas``, both reached through their public
calls (``MonteCarloIntegrator(backend="pallas")`` on the CPU; the JAX
kernel's final states are its last thinned draw), over product targets
and proposals with CUSTOM dimensions first and last: BASELINE's c9f cell
scaled down (a Beta(2, 5) table target and sampler-mode proposal in
dimension 0), a gapped proposal dimension, a sampler-mode and a gapped
dimension together (the logq sums the sampler-mode dimensions first, as
the JAX kernel does), a table target under a joint walk, and a CUSTOM
proposal under a joint log density.  Tolerances as
``tests/test_torch_mcmc.py``'s: at most 1 % of the chains split, means
within 1e-5, acceptance within 1e-4, error bars within rel 1e-3.  The
CUDA kernel is held against the plain version in ``test_torch_cuda.py``.
"""

import warnings

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import mcmc_nd as api_nd
from tpu_montecarlo_torch.ops.mcmc_nd_kernel import McmcNdConfig, mcmc_nd_cuda
from tpu_montecarlo_torch.ops.mcmc_kernel import Mode
from tpu_montecarlo_torch.sampling import DistKind

N_CHAINS, N_STEPS, N_BURNIN = 1024, 40, 10
SPLIT_RTOL, MAX_SPLIT = 1e-4, 0.01
VALUE_ATOL = 1e-5
ACCEPT_ATOL = 1e-4
STDERR_RTOL = 1e-3


def bimodal(x):
    # BASELINE config 5's target (benchmarks/run_all.py:185-188).
    return 0.5 * np.exp(-0.5 * (x + 2.0) ** 2) + 0.5 * np.exp(-0.5 * (x - 2.0) ** 2)


_GAP_X = np.linspace(0.0, 1.0, 2048)
_GAP_P = np.where((_GAP_X > 0.4) & (_GAP_X < 0.6), 0.0, 1.0)


def _c9e_target(x, y):
    # c9e's bivariate normal, rho = 0.8 (run_all.py:386-390).
    return -(x * x - 1.6 * x * y + y * y) / 0.72


def _dist(pkg, spec):
    name, *args = spec
    if name == "bimodal":
        return pkg.Distribution.from_pdf(bimodal, support=(-6.0, 6.0))
    if name == "gap":
        return pkg.Distribution.from_pdf_table(_GAP_X, _GAP_P)
    return getattr(pkg.Distribution, name)(*args)


def _make(pkg, spec):
    if callable(spec):
        return spec
    if isinstance(spec, dict):
        return pkg.RandomWalk(**spec)
    return [_dist(pkg, s) for s in spec]


F2 = [lambda x, y: x * y, lambda x, y: x + y * y]
F3 = [lambda x, y, z: x * y + z, lambda x, y, z: y * y - z]
BETA = ("beta", 2.0, 5.0)
# id: (fns, target, proposal, stderr).
CASES = {
    # c9f (run_all.py:401-416), scaled down: CUSTOM dimension first.
    "c9f": (F2, [BETA, ("normal", 0.0, 1.0)], [BETA, ("normal", 0.0, 2.0)],
            True),
    # A gapped proposal dimension last.
    "gapped-last": (F2, [("normal", 0.0, 1.0), ("uniform", 0.0, 1.0)],
                    [("normal", 0.0, 2.0), ("gap",)], False),
    # A sampler-mode and a gapped dimension: logq sums the first, then
    # the others.
    "sampler-and-gapped": (F2, [BETA, ("uniform", 0.0, 1.0)], [BETA, ("gap",)],
                           True),
    # A table target dimension in the middle; a sampler-mode proposal
    # dimension last, after two closed forms.
    "d3-table-middle": (F3, [("normal", 0.0, 1.0), ("bimodal",), BETA],
                        [("normal", 0.0, 2.0), ("normal", 0.0, 3.0), BETA],
                        False),
    "adaptive-walk-table-first": (
        F2, [("bimodal",), ("normal", 0.0, 1.0)],
        dict(step_size=[1.0, 0.8], adapt=True, init_range=(-2.0, 2.0)), True),
    "joint-target-custom-proposal": (
        F2, _c9e_target, [("normal", 0.0, 2.0), ("bimodal",)], False),
}


def _jax_run(case, seed=42):
    fns, target, proposal, stderr = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback to the XLA sweep
        r = jmc.MonteCarloIntegrator(backend="pallas").integrate_mcmc(
            fns, _make(jmc, target), _make(jmc, proposal), n_steps=N_STEPS,
            n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=seed,
            return_stderr=stderr, return_samples=N_STEPS,
        )
    return r, np.asarray(r.samples[-1])


def _port_run(case, monkeypatch, seed=42):
    fns, target, proposal, stderr = CASES[case]
    outs = []

    def spy(*args):
        outs.append(mcmc_nd_cuda(*args))
        return outs[-1]

    monkeypatch.setattr(api_nd, "mcmc_nd_cuda", spy)
    r = tm.MonteCarloIntegrator(device="cpu").integrate_mcmc(
        fns, _make(tm, target), _make(tm, proposal), n_steps=N_STEPS,
        n_chains=N_CHAINS, n_burnin=N_BURNIN, seed=seed, return_stderr=stderr,
    )
    assert len(outs) == 1
    return r, outs[0].x_final.numpy().T


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(case, monkeypatch):
    want, x_jax = _jax_run(case)
    got, x_port = _port_run(case, monkeypatch)
    assert x_port.shape == x_jax.shape
    split = (np.abs(x_port - x_jax) > SPLIT_RTOL * (1.0 + np.abs(x_jax))).any(axis=1)
    assert split.mean() <= MAX_SPLIT, f"{split.mean():.2%} of the chains split"
    assert np.all(np.isfinite(got.values))
    np.testing.assert_allclose(got.values, np.asarray(want.values, np.float64),
                               rtol=0.0, atol=VALUE_ATOL)
    assert abs(got.acceptance_rate - want.acceptance_rate) <= ACCEPT_ATOL
    if CASES[case][3]:
        np.testing.assert_allclose(got.stderr, want.stderr, rtol=STDERR_RTOL)


def test_c9f_is_near_its_closed_form():
    # E[XY] = E[X] E[Y] = 0 under Beta(2, 5) x N(0, 1); 6 error bars.
    fns, target, proposal, _ = CASES["c9f"]
    r = tm.integrate_mcmc(fns[:1], _make(tm, target), _make(tm, proposal),
                          n_steps=200, n_chains=1024, n_burnin=50,
                          return_stderr=True, device="cpu")
    assert abs(r.values[0]) < 6.0 * r.stderr[0]


def test_custom_routes_compile_in_per_dimension():
    integ = tm.MonteCarloIntegrator(device="cpu")
    fns, target, proposal, _ = CASES["sampler-and-gapped"]
    parsed = integ._parse_nd_mcmc_args(_make(tm, target), _make(tm, proposal))
    program, cfg, _ = integ._nd_mcmc_kernel_program(fns, _make(tm, proposal),
                                                    parsed, 10, 2, False)
    c, u = DistKind.CUSTOM, DistKind.UNIFORM
    assert cfg.prop_gapped == (False, True)
    assert cfg.compiled == (Mode.INDEPENDENCE, 2, (c, c), (c, u), (False, True))
    src = program.source()
    assert "#define TMC_PROP_KINDS 3, 3\n" in src
    assert "#define TMC_PROP_GAPPED 0, 1\n" in src
    assert "#define TMC_TARG_KINDS 3, 0\n" in src
    # A closed-form proposal compiles in no route.
    n = DistKind.NORMAL
    plain = McmcNdConfig(Mode.INDEPENDENCE, 2, (n, n), (c, n), 10, 2)
    assert plain.prop_gapped == (False, False)
    with pytest.raises(ValueError, match="set only for CUSTOM ones"):
        McmcNdConfig(Mode.INDEPENDENCE, 2, (n, c), (n, n), 10, 2,
                     prop_gapped=(True, False))
