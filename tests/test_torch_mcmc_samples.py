"""Thinned MCMC draws (``return_samples=m``) in the port's three MCMC paths.

The draws are the post-step states at sampling steps ``j * (n_steps //
m)``, ``j < m`` (the tempered kernel's: the cold rung's, after the
exchange), in the JAX package's public shapes: (m, chains) over one
dimension and for a tempered 1-D Distribution target, (m, chains, d)
otherwise, chains being the kernels' count (at least 1,024).

* The draw grid, bit for bit: the chains' steps do not depend on
  ``n_steps`` (the counters run through burn-in and sampling), so draw j
  of a run is the final state of the same run cut after sampling step
  ``j * stride``.  Checked on each path with odd ``n_steps``, ``m`` not
  dividing ``n_steps``, ``m = 1``, ``m = n_steps``, a CUSTOM table target
  and an extended family.
* Values, error bars, acceptance and swap rates bit-equal with and
  without draws.
* The JAX package's own tests of draws (``tests/test_mcmc_samples.py``
  and the tempered ones of ``tests/test_tempering.py``) on the port.
* The kernels' draw writer (``csrc/mcmc_pipeline.cuh``), built with the
  host's g++: m rows and nothing past them, whatever steps are left after
  the last draw.

``test_torch_mcmc_diagnostics.py`` holds the draws against the JAX
kernels' chain for chain; ``test_torch_cuda.py`` the CUDA kernels' against
these plain versions.
"""

import contextlib
import math

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.mcmc_kernel import plan_chains, plan_mcmc_grid


def logmix(x):
    # 0.5 N(-4,1) + 0.5 N(4,1): E[X] = 0, E[X^2] = 17.
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


def bimodal(x):
    return 0.5 * np.exp(-0.5 * (x + 2) ** 2) + 0.5 * np.exp(-0.5 * (x - 2) ** 2)


D = tm.Distribution
N01, N02 = D.normal(0.0, 1.0), D.normal(0.0, 2.0)
CHAINS = plan_mcmc_grid(plan_chains(256, None)).chains_actual  # 1024
LADDER = [1.0, 2.0, 4.0, 8.0, 16.0]


def _run(fns, target, proposal, **kw):
    return tm.integrate_mcmc(fns, target, proposal, device="cpu", **kw)


@contextlib.contextmanager
def _final_states(monkeypatch):
    """Collects the final states (d, chains) of every run of the three
    plain versions, caught at their wrappers."""
    from tpu_montecarlo_torch.api import mcmc as api_1d
    from tpu_montecarlo_torch.api import mcmc_nd as api_nd
    from tpu_montecarlo_torch.api import tempering as api_pt

    finals = []
    for module, name in ((api_1d, "mcmc_cuda"), (api_nd, "mcmc_nd_cuda"),
                         (api_pt, "mcmc_pt_cuda")):
        wrapper = getattr(module, name)

        def spy(*args, _wrapper=wrapper):
            out = _wrapper(*args)
            finals.append(out.x_final.reshape(-1, out.x_final.shape[-1]))
            return out

        monkeypatch.setattr(module, name, spy)
    yield finals


# -- the draw grid ------------------------------------------------------------

# id: (functions, target, proposal, temperatures, n_steps, m)
GRID = {
    "1d-odd-steps": ([lambda x: x], N01, N02, None, 21, 4),
    "1d-m-does-not-divide": ([lambda x: x], N01, tm.RandomWalk(adapt=True),
                             None, 20, 3),
    "1d-one-draw": ([lambda x: x], D.laplace(3.0, 1.0),
                    D.logistic(0.0, 2.0), None, 9, 1),
    "1d-every-step": ([lambda x: x * x],
                      D.from_pdf(bimodal, support=(-6.0, 6.0)),
                      D.uniform(-6.0, 6.0), None, 7, 7),
    "nd-joint": ([lambda x, y: x * y],
                 lambda x, y: -(x * x - 1.6 * x * y + y * y) / 0.72,
                 [N02, N02], None, 15, 4),
    "nd-table-dimension": ([lambda x, y: x + y], [D.beta(2.0, 5.0), N01],
                           [D.beta(2.0, 5.0), N02], None, 12, 12),
    "nd-family-walk": ([lambda x, y: x + y],
                       [D.gumbel(1.0, 0.5), D.cauchy(0.0, 1.0)],
                       tm.RandomWalk(step_size=[0.6, 1.5], adapt=True), None,
                       11, 2),
    "tempered-1d-distribution": ([lambda x: x], D.normal(2.0, 1.0),
                                 tm.RandomWalk(step_size=1.5), [1.0, 4.0],
                                 13, 5),
    "tempered-joint": ([lambda x: x, lambda x: x * x], logmix,
                       tm.RandomWalk(step_size=0.5, adapt=True,
                                     init_range=(3.0, 5.0)),
                       [1.0, 2.0, 4.0, 8.0], 10, 10),
    "tempered-table-target": ([lambda x: x],
                              D.from_pdf(bimodal, support=(-6.0, 6.0)),
                              D.normal(0.0, 4.0), [1.0, 2.0, 4.0], 9, 1),
}


@pytest.mark.parametrize("case", list(GRID))
def test_draw_j_is_the_state_after_step_j_stride(case, monkeypatch):
    fns, target, proposal, temps, n_steps, m = GRID[case]
    kw = dict(n_chains=256, n_burnin=4, seed=9, temperatures=temps)
    stride = n_steps // m
    with _final_states(monkeypatch) as finals:
        r = _run(fns, target, proposal, n_steps=n_steps, return_samples=m,
                 **kw)
        for j in range(m):
            _run(fns, target, proposal, n_steps=j * stride + 1, **kw)
    s = r.samples
    assert s.dtype == np.float32 and s.shape[:2] == (m, CHAINS)
    # One Distribution target: (m, chains); else (m, chains, d).
    assert s.ndim == (2 if isinstance(target, D) else 3)
    draws = s.reshape(m, CHAINS, -1)
    for j in range(m):
        np.testing.assert_array_equal(draws[j], finals[1 + j].numpy().T,
                                      err_msg=f"draw {j}")


@pytest.mark.parametrize("case", ["1d-odd-steps", "nd-joint",
                                  "tempered-joint"])
def test_values_unchanged_by_sampling(case):
    fns, target, proposal, temps, n_steps, m = GRID[case]
    kw = dict(n_chains=256, n_burnin=4, seed=11, n_steps=n_steps,
              temperatures=temps, return_stderr=True)
    base = _run(fns, target, proposal, **kw)
    with_s = _run(fns, target, proposal, return_samples=m, **kw)
    np.testing.assert_array_equal(base.values, with_s.values)
    np.testing.assert_array_equal(base.stderr, with_s.stderr)
    assert base.acceptance_rate == with_s.acceptance_rate
    assert base.diagnostics == with_s.diagnostics


# -- the JAX package's tests of draws on the port ------------------------------


def test_shape_dtype_and_distribution():
    r = _run([lambda x: x], D.normal(3.0, 2.0), D.normal(3.0, 4.0),
             n_steps=1000, n_chains=512, n_burnin=200, seed=42,
             return_samples=50)
    s = r.samples
    assert s.shape == (50, CHAINS) and s.dtype == np.float32
    assert abs(s.mean() - 3.0) < 0.2
    assert abs(s.std() - 2.0) < 0.3


def test_thinning_reduces_autocorrelation():
    r = _run([lambda x: x], N01, tm.RandomWalk(step_size=2.4), n_steps=2000,
             n_chains=256, n_burnin=200, seed=7, return_samples=20)
    s = r.samples
    corr = np.corrcoef(s[:-1].ravel(), s[1:].ravel())[0, 1]
    assert abs(corr) < 0.15


def test_composes_with_stderr_and_diagnostics():
    r = _run([lambda x: x * x], N01, N02, n_steps=1000, n_chains=512,
             n_burnin=100, seed=1, return_samples=10, return_stderr=True,
             return_diagnostics=True)
    assert r.samples.shape == (10, CHAINS)
    assert r.stderr is not None and r.stderr[0] > 0
    assert abs(float(r.diagnostics["r_hat"][0]) - 1.0) < 0.2
    assert abs(r.values[0] - 1.0) < 0.1


def test_deterministic_per_seed():
    kw = dict(n_steps=300, n_chains=256, n_burnin=50, return_samples=5,
              seed=3)
    a = _run([lambda x: x], N01, N02, **kw)
    b = _run([lambda x: x], N01, N02, **kw)
    np.testing.assert_array_equal(a.samples, b.samples)


def test_adaptive_walk_draws():
    r = _run([lambda x: x], D.normal(2.0, 1.0),
             tm.RandomWalk(step_size=1.0, adapt=True, init_range=(-2.0, 6.0)),
             n_steps=500, n_chains=512, n_burnin=200, seed=6,
             return_samples=10)
    assert r.samples.shape[0] == 10
    assert abs(r.samples.mean() - 2.0) < 0.2
    assert abs(r.samples.std() - 1.0) < 0.2


def test_joint_target_shape_and_correlation():
    rho, c = -0.5, 1.0 / (2.0 * (1.0 - 0.25))
    r = _run([lambda x, y: x * y],
             lambda x, y: -c * (x * x - 2.0 * rho * x * y + y * y),
             tm.RandomWalk(step_size=1.0, init_range=(-3.0, 3.0)),
             n_steps=2000, n_chains=512, n_burnin=500, seed=2,
             return_samples=25)
    s = r.samples
    assert s.shape == (25, CHAINS, 2)
    emp = np.corrcoef(s[..., 0].ravel(), s[..., 1].ravel())[0, 1]
    assert abs(emp - rho) < 0.1


def test_product_target():
    r = _run([lambda x, y: x + y], [D.normal(1.0, 1.0), D.normal(-1.0, 0.5)],
             [D.normal(1.0, 2.0), D.normal(-1.0, 1.0)], n_steps=800,
             n_chains=512, n_burnin=200, seed=4, return_samples=25,
             return_stderr=True)
    s = r.samples
    assert s.shape == (25, CHAINS, 2)
    assert abs(s[..., 0].mean() - 1.0) < 0.15
    assert abs(s[..., 1].mean() + 1.0) < 0.1


def test_rejects_more_than_n_steps():
    for temps in (None, [1.0, 2.0]):
        with pytest.raises(ValueError, match="return_samples"):
            _run([lambda x: x], N01, N02, n_steps=100, n_chains=256,
                 n_burnin=10, return_samples=200, temperatures=temps)


def test_rejects_stateful():
    with pytest.raises(ValueError, match="stateless"):
        _run([lambda x: x], N01, N02, n_steps=100, n_chains=256, n_burnin=10,
             return_samples=10, return_state=True)


# The tempered cases of tests/test_tempering.py.

def test_tempered_samples_visit_both_modes():
    pt = _run([lambda x: x], logmix,
              tm.RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0)),
              n_steps=2000, n_chains=512, n_burnin=500, seed=15,
              temperatures=LADDER, return_samples=20)
    s = pt.samples
    assert s.shape == (20, CHAINS, 1)  # a joint target keeps d
    assert 0.3 < float(np.mean(s < 0.0)) < 0.7
    assert abs(float(np.mean(s * s)) - 17.0) < 2.0


def test_tempered_samples_shape_1d_distribution_target():
    pt = _run([lambda x: x], D.normal(2.0, 1.0), tm.RandomWalk(step_size=1.5),
              n_steps=400, n_chains=256, n_burnin=100, seed=16,
              temperatures=[1.0, 4.0], return_samples=8)
    assert pt.samples.shape == (8, CHAINS)  # a 1-D target drops d
    assert abs(pt.samples.mean() - 2.0) < 0.3


# -- the libraries without the outputs ------------------------------------------

# sha256 of the generated source (the integrands, defines and layout the
# kernel includes) of c5b's, c9e's and c12's libraries as their public
# calls build them, read from the port before the outputs were added: a
# run without diagnostics or draws builds the library it built then.
SOURCE_SHA256 = {
    "c5b": "0556e8042ab90d086dc22a452498b64c3da97a23e0f2eeaa7ff3dc0121d5e604",
    "c9e": "4c5b08765fdcca5004f4b154c709cf0b01eaec31a2e7433ac8e27d4c42362ec0",
    "c12": "1a131cea1dafc8ddc64fe906bb544cd6a9197ea0ae5e4d72f0c12106e82b8da9",
}


def _cell_source(cell, **outputs):
    integ = tm.MonteCarloIntegrator(device="cpu")
    shape = (10_000, 1_000, True, outputs.get("diag", False),
             outputs.get("draws", 0))
    if cell == "c5b":
        prog, cfg, _, _ = integ._mcmc_kernel_program(
            integ._trace_user_functions([lambda x: x * x]), N01, N02, *shape)
        return prog.source(cfg)
    if cell == "c9e":
        target = GRID["nd-joint"][1]
        parsed = integ._parse_nd_mcmc_args(target, [N02, N02])
        return integ._nd_mcmc_kernel_program(
            [lambda x, y: x * y], [N02, N02], parsed, *shape)[0].source()
    walk = tm.RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0))
    parsed = integ._parse_nd_mcmc_args(logmix, walk)
    return integ._pt_kernel_program(
        [lambda x: x, lambda x: x * x], walk, parsed,
        (1.0, 0.5, 0.25, 0.125), *shape)[0].source()


@pytest.mark.parametrize("cell", list(SOURCE_SHA256))
def test_libraries_without_outputs_keep_their_source(cell):
    import hashlib

    bare = _cell_source(cell)
    assert hashlib.sha256(bare.encode()).hexdigest() == SOURCE_SHA256[cell]
    # The outputs only add their defines (the tempered kernel's rung count
    # stays last).
    defines = "#define TMC_DIAG 1\n#define TMC_SAMPLES 1\n"
    rungs = "#define TMC_T 4\n" if cell == "c12" else ""
    assert bare.endswith(rungs)
    assert _cell_source(cell, diag=True, draws=5) == (
        bare[:len(bare) - len(rungs)] + defines + rungs)


# -- the kernels' draw writer, compiled with the host's g++ -------------------

_WRITER_SHIM = r"""
#include <cstddef>
#include <cstdint>

#include "integrand_math.cuh"
#include "mcmc_pipeline.cuh"

// One chain's lane through a sampling phase of n_steps steps from step
// `begin` (in one piece, or with diagnostics in its halves and odd step)
// of a D-dimensional state (step t's post-step state: t - begin + 0.5 in
// dimension 0, minus that in dimension 1), writing its draws into `out`
// as the kernels do.
template <int D, bool kDiag>
void run(int begin, int n_steps, int m, int stride, int chain, int n_chains,
         bool writes, float* out) {
  auto o = tmc::StepOutputs<1, D, kDiag, true>::start(
      tmc::Draws{out, m, stride}, chain, n_chains, writes);
  auto steps = [&](uint32_t b, uint32_t e) {
    for (uint32_t i = b; i < e; ++i) {
      float x[D];
      const float t = float(i - uint32_t(begin)) + 0.5f;
      for (int dim = 0; dim < D; ++dim) x[dim] = dim ? -t : t;
      o.step(x);
    }
  };
  auto half_done = [] {};
  tmc::sampling_phase(uint32_t(begin), uint32_t(n_steps), o, steps,
                      half_done);
}

extern "C" void tmc_draws(int d, int diag, int begin, int n_steps, int m,
                          int stride, int chain, int n_chains, int writes,
                          float* out) {
  if (d == 1 && !diag) run<1, false>(begin, n_steps, m, stride, chain, n_chains, writes, out);
  if (d == 1 && diag) run<1, true>(begin, n_steps, m, stride, chain, n_chains, writes, out);
  if (d == 2 && !diag) run<2, false>(begin, n_steps, m, stride, chain, n_chains, writes, out);
  if (d == 2 && diag) run<2, true>(begin, n_steps, m, stride, chain, n_chains, writes, out);
}
"""


@pytest.fixture(scope="module")
def writer_lib(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess

    from tpu_montecarlo_torch.ops.build import CSRC

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("draw_writer")
    (out / "shim.cpp").write_text(_WRITER_SHIM)
    so = out / "libwriter.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-D__device__=",
         "-D__forceinline__=inline", "-I", str(CSRC), str(out / "shim.cpp"),
         "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.tmc_draws.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.tmc_draws.restype = None
    return lib


# (n_steps, m): m dividing n_steps or not, remainders far past the stride
# (1001 = 300 x 3 + 101), m = 1 and m = n_steps.
WRITER_RUNS = [(100, 30), (1001, 300), (10_000, 3_000), (1001, 7), (7, 3),
               (10, 10), (10, 1), (1, 1)]
# (d, diagnostics, n_steps, m); diagnostics need n_steps >= 4.
WRITER_CASES = [(d, diag, n, m) for diag in (False, True) for d in (1, 2)
                for n, m in WRITER_RUNS if n >= 4 or not diag]


@pytest.mark.parametrize(
    "d,diag,n_steps,m", WRITER_CASES,
    ids=[f"d{d}-{'diag' if g else 'plain'}-steps{n}-m{m}"
         for d, g, n, m in WRITER_CASES])
def test_draw_writer_writes_m_rows_and_no_more(writer_lib, d, diag, n_steps,
                                               m):
    """Through a sampling phase (with diagnostics: in halves), the
    writing lane stores the states after steps j * stride, j < m, into its
    column of rows 0..m-1 and nothing past them; a lane that does not
    write stores nothing."""
    stride = n_steps // m
    begin, chains, chain, guard = 37, 4, 2, 8
    sentinel = np.float32(-7777.0)
    buf = np.full((m + guard, d, chains), sentinel, np.float32)
    writer_lib.tmc_draws(d, diag, begin, n_steps, m, stride, chain, chains, 1,
                         buf.ctypes.data)
    steps = np.arange(m) * stride + np.float32(0.5)
    want = np.full_like(buf, sentinel)
    want[:m, 0, chain] = steps
    if d == 2:
        want[:m, 1, chain] = -steps
    np.testing.assert_array_equal(buf, want)
    quiet = np.full_like(buf, sentinel)
    writer_lib.tmc_draws(d, diag, begin, n_steps, m, stride, chain, chains, 0,
                         quiet.ctypes.data)
    assert (quiet == sentinel).all()
