"""The MCMC kernels' pipelined independence step (``csrc/mcmc_pipeline.cuh``)
compiled with the host's g++ and held against a numpy float32 loop, and
the chain layouts the kernels compile in.

The header's decisions, its groups of ``group * lanes`` steps (with a
tail group when a phase is not a multiple of that) and its lane exchange
compile on the host; the exchange runs each lane as a thread, with a
barrier-backed shuffle in place of ``__shfl_sync``.  Every lane of a chain
must end with the same state, and that state and every sampling step's
(x, accepted) must equal the loop's, bit for bit: the decision is the
float32 ``((logp' + logq) - logp) - logq'`` against ``logf(u)``, strict.
The candidates include the edge cases: a tie ``la == logf(u)`` (rejected),
``logf(u) = 0`` (u = 1), the -100 log-pdf floor, a -inf target density
and a chain that starts at -inf.  Needs no JAX and no GPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.ops.build import CSRC
from tpu_montecarlo_torch.ops.mcmc_kernel import (
    Layout,
    McmcConfig,
    McmcProgram,
    Mode,
    check_layout,
    default_layout,
)
from tpu_montecarlo_torch.ops.mcmc_pt_kernel import default_pt_layout
from tpu_montecarlo_torch.sampling import DistKind

F32 = np.float32
_PAD = 64  # candidates past a run's end: made by a tail group, never used

_SHIM = r"""
#include <array>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

static std::barrier<>* g_bar = nullptr;
static float g_table[32];
static thread_local int t_lane = 0;

// __shfl_sync(full mask, v, src, width) for lanes running as threads.
static float host_shfl(float v, int src, int width) {
  g_table[t_lane] = v;
  g_bar->arrive_and_wait();
  const float r = g_table[src % width];
  g_bar->arrive_and_wait();
  return r;
}
#define TMC_HOST_SHFL host_shfl

#include "integrand_math.cuh"
#include "mcmc_pipeline.cuh"

namespace {

struct FromArrays {
  const float *x, *logp, *logq, *logu;
  tmc::Candidate<1> operator()(uint32_t i) const {
    tmc::Candidate<1> c;
    c.x[0] = x[i];
    c.logp = logp[i];
    c.logq = logq[i];
    c.logu = logu[i];
    return c;
  }
};

struct Record {
  float* xs;
  uint8_t* acc;
  int n;
  void operator()(const float (&x)[1], bool accepted) {
    xs[n] = x[0];
    acc[n] = accepted;
    ++n;
  }
};

// Runs one chain on L lanes (threads); 0 when every lane ends with lane
// 0's records and state, which go to xs, acc and state.
template <int L, int G>
int run(int n_burnin, int n_steps, const float* init, const FromArrays& make,
        float* xs, uint8_t* acc, float* state) {
  std::barrier<> bar(L);
  g_bar = &bar;
  std::vector<std::vector<float>> lane_xs(L, std::vector<float>(n_steps));
  std::vector<std::vector<uint8_t>> lane_acc(L, std::vector<uint8_t>(n_steps));
  std::vector<std::array<float, 3>> lane_state(L);
  const uint32_t burn = uint32_t(n_burnin);
  const uint32_t end = burn + uint32_t(n_steps);
  std::vector<std::thread> lanes;
  for (int l = 0; l < L; ++l) {
    lanes.emplace_back([&, l] {
      t_lane = l;
      float x[1] = {init[0]};
      float logp = init[1], logq = init[2];
      tmc::NoVisit none;
      tmc::SelectStep<1, tmc::NoVisit> burn_in{x, logp, logq, none};
      tmc::pipeline<L, G, tmc::Candidate<1>>(0u, burn, l, make, burn_in);
      Record rec{lane_xs[l].data(), lane_acc[l].data(), 0};
      tmc::SelectStep<1, Record> sample{x, logp, logq, rec};
      tmc::pipeline<L, G, tmc::Candidate<1>>(burn, end, l, make, sample);
      lane_state[l] = {x[0], logp, logq};
    });
  }
  for (auto& t : lanes) t.join();
  int differ = 0;
  for (int l = 1; l < L; ++l) {
    differ |= std::memcmp(lane_xs[l].data(), lane_xs[0].data(),
                          n_steps * sizeof(float)) != 0;
    differ |= lane_acc[l] != lane_acc[0];
    differ |= std::memcmp(&lane_state[l], &lane_state[0],
                          sizeof(lane_state[0])) != 0;
  }
  std::memcpy(xs, lane_xs[0].data(), n_steps * sizeof(float));
  std::memcpy(acc, lane_acc[0].data(), n_steps);
  std::memcpy(state, lane_state[0].data(), sizeof(lane_state[0]));
  return differ;
}

template <int L>
int run_group(int group, int n_burnin, int n_steps, const float* init,
              const FromArrays& make, float* xs, uint8_t* acc, float* state) {
  switch (group) {
    case 1: return run<L, 1>(n_burnin, n_steps, init, make, xs, acc, state);
    case 3: return run<L, 3>(n_burnin, n_steps, init, make, xs, acc, state);
    case 4: return run<L, 4>(n_burnin, n_steps, init, make, xs, acc, state);
  }
  return -1;
}

}  // namespace

extern "C" int tmc_run(int lanes, int group, int n_burnin, int n_steps,
                       const float* init, const float* cx, const float* clp,
                       const float* clq, const float* clu, float* xs,
                       uint8_t* acc, float* state) {
  const FromArrays make{cx, clp, clq, clu};
  switch (lanes) {
    case 1: return run_group<1>(group, n_burnin, n_steps, init, make, xs, acc, state);
    case 2: return run_group<2>(group, n_burnin, n_steps, init, make, xs, acc, state);
    case 4: return run_group<4>(group, n_burnin, n_steps, init, make, xs, acc, state);
    case 8: return run_group<8>(group, n_burnin, n_steps, init, make, xs, acc, state);
  }
  return -1;
}
"""


@pytest.fixture(scope="module")
def pipeline_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("pipeline")
    (out / "shim.cpp").write_text(_SHIM)
    so = out / "libpipeline.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared",
         "-fPIC", "-D__device__=", "-D__forceinline__=inline", "-I",
         str(CSRC), str(out / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.tmc_run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
    lib.tmc_run.restype = ctypes.c_int
    return lib


def _reference(n_burnin, n_steps, init, cx, clp, clq, clu):
    """The decisions as a float32 loop: (xs, accepted) of the sampling
    steps and the final (x, logp, logq)."""
    x, logp, logq = (F32(v) for v in init)
    xs, acc = [], []
    with np.errstate(invalid="ignore"):
        for i in range(n_burnin + n_steps):
            la = ((clp[i] + logq) - logp) - clq[i]
            accept = bool(clu[i] < la)
            if accept:
                x, logp, logq = cx[i], clp[i], clq[i]
            if i >= n_burnin:
                xs.append(x)
                acc.append(accept)
    return np.array(xs, F32), np.array(acc, bool), np.array([x, logp, logq], F32)


def _candidates(n_burnin, n_steps, init, seed):
    """Candidates of a run, with its edge cases, and NaN past its end."""
    n = n_burnin + n_steps
    rs = np.random.default_rng(seed)
    cx = rs.normal(0.0, 2.0, n).astype(F32)
    clp = (F32(-0.5) * cx * cx).astype(F32)
    clq = rs.normal(-2.0, 1.0, n).astype(F32)
    clu = np.log(rs.uniform(0.0, 1.0, n)).astype(F32)
    clu[::11] = 0.0                 # u = 1: accepted only when la > 0
    clp[3::13] = -100.0             # the log-pdf floor
    clq[5::17] = -100.0
    clp[7::19] = -np.inf            # a joint target's log(0)
    # Ties: la == logf(u) exactly, which rejects.
    for t in range(2, n, 23):
        _, _, (_, logp, logq) = _reference(t, 0, init, cx, clp, clq, clu)
        with np.errstate(invalid="ignore"):
            clu[t] = ((clp[t] + logq) - logp) - clq[t]
    pad = np.full(_PAD, np.nan, F32)
    return [np.concatenate([a, pad]) for a in (cx, clp, clq, clu)]


RUNS = [(0, 1), (0, 7), (5, 17), (37, 250), (0, 1201)]


@pytest.mark.parametrize("n_burnin,n_steps", RUNS,
                         ids=[f"burn{b}-steps{s}" for b, s in RUNS])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_pipelined_decisions_match_float32_loop(pipeline_lib, lanes, group,
                                                n_burnin, n_steps):
    init = np.array([0.5, -0.125, -1.5], F32)
    if n_steps == 250:
        init[1] = -np.inf  # a chain that starts where the target is 0
    cand = _candidates(n_burnin, n_steps, init, seed=lanes * 100 + group)
    xs = np.zeros(n_steps, F32)
    acc = np.zeros(n_steps, np.uint8)
    state = np.zeros(3, F32)
    differ = pipeline_lib.tmc_run(
        lanes, group, n_burnin, n_steps, init.ctypes.data,
        *(c.ctypes.data for c in cand), xs.ctypes.data, acc.ctypes.data,
        state.ctypes.data,
    )
    assert differ == 0, "the lanes of a chain hold different states"
    want_xs, want_acc, want_state = _reference(n_burnin, n_steps, init, *cand)
    np.testing.assert_array_equal(acc.astype(bool), want_acc)
    np.testing.assert_array_equal(xs, want_xs)
    np.testing.assert_array_equal(state, want_state)
    # The edge cases occur in the run: ties, u = 1, the floor, -inf.
    n = n_burnin + n_steps
    if n >= 250:
        assert 0 < want_acc.sum() < n_steps


# -- the layouts the kernels compile in ---------------------------------------


@pytest.mark.parametrize("k,lanes,group", [
    (1, 8, 4), (8, 8, 4), (9, 4, 4), (32, 4, 4), (33, 1, 2), (127, 1, 2),
])
def test_default_layout_spreads_few_integrands_widest(k, lanes, group):
    assert default_layout(Mode.INDEPENDENCE, k) == Layout(lanes, group)
    # A walk's step waits on the one before: one lane, whatever k is.
    for mode in (Mode.RANDOM_WALK, Mode.ADAPTIVE):
        assert default_layout(mode, k) == Layout(1, 8)


def test_layouts_the_kernels_cannot_run_raise():
    assert check_layout(Mode.INDEPENDENCE, (2, 3)) == Layout(2, 3)
    for bad in ((3, 1), (64, 1), (0, 1), (4, 0)):
        with pytest.raises(ValueError, match="divide a warp"):
            check_layout(Mode.INDEPENDENCE, bad)
    with pytest.raises(ValueError, match="one lane per chain"):
        check_layout(Mode.ADAPTIVE, (4, 2))


def test_sources_compile_in_mode_families_and_layout():
    n, e = DistKind.NORMAL, DistKind.EXPONENTIAL
    program = McmcProgram((tm.trace_function(lambda x: x * x),))
    indep = McmcConfig(Mode.INDEPENDENCE, e, n, 10, 2)
    src = program.source(indep)
    for line in ("#define TMC_MODE 0", "#define TMC_PROP_KIND 2",
                 "#define TMC_TARG_KIND 1", "#define TMC_LANES 8",
                 "#define TMC_GROUP 4"):
        assert line + "\n" in src
    # A walk draws from no proposal family and runs one lane.
    walk = McmcConfig(Mode.ADAPTIVE, e, n, 10, 2)
    src = program.source(walk)
    assert "TMC_PROP_KIND" not in src and "#define TMC_LANES 1\n" in src
    # Only a CUSTOM proposal compiles in its route (gapped or sampler).
    assert "TMC_PROP_GAPPED" not in program.source(indep) + src
    assert indep.compiled == (Mode.INDEPENDENCE, e, n, False)
    assert walk.compiled == (Mode.ADAPTIVE, None, n, False)
    # A fixed layout is checked against each mode it is asked for.
    fixed = McmcProgram(program.fns, layout=(2, 3))
    assert "#define TMC_LANES 2\n#define TMC_GROUP 3\n" in fixed.source(indep)
    with pytest.raises(ValueError, match="one lane per chain"):
        fixed.source(walk)


def test_nd_sources_compile_in_the_layout_and_tempered_ones_do_not():
    integ = tm.MonteCarloIntegrator(device="cpu")
    n2 = tm.Distribution.normal(0.0, 2.0)
    rho = 0.8
    c = 1.0 / (2.0 * (1.0 - rho * rho))
    target = lambda x, y: -c * (x * x - 2.0 * rho * x * y + y * y)  # noqa: E731
    walk = tm.RandomWalk(init_range=(-4.0, 4.0))
    for proposal, layout in (([n2, n2], Layout(8, 4)), (walk, Layout(1, 8))):
        parsed = integ._parse_nd_mcmc_args(target, proposal)
        program, _, _ = integ._nd_mcmc_kernel_program(
            [lambda x, y: x * y], proposal, parsed, 10, 2, False)
        assert program.layout == layout
        assert (f"#define TMC_LANES {layout.lanes}\n"
                f"#define TMC_GROUP {layout.group}\n") in program.source()
    # The tempered kernel compiles in its own layout (rungs on lanes, or
    # the ladder), never the nd kernel's TMC_LANES / TMC_GROUP.
    parsed = integ._parse_nd_mcmc_args(target, walk)
    program, _, _, _ = integ._pt_kernel_program(
        [lambda x, y: x * y], walk, parsed, (1.0, 0.5), 10, 2, False)
    src = program.source()
    assert program.layout == default_pt_layout(Mode.RANDOM_WALK, 2, 1)
    assert "TMC_LANES" not in src and "TMC_GROUP" not in src
    assert (f"#define TMC_PT_RUNG_LANES {program.layout.rung_lanes}\n"
            f"#define TMC_PT_LANES {program.layout.lanes}\n"
            f"#define TMC_PT_GROUP {program.layout.group}\n") in src
