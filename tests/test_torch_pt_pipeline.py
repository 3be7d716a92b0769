"""The tempered kernel's step and exchange (``csrc/mcmc_pipeline.cuh``)
compiled with the host's g++ and held against a numpy float32 loop that
runs ``csrc/mcmc_pt.cu``'s ladder layout (``rung_move``, ``exchange``).

A chain's T rungs run on T' * L lanes, T' the smallest power of two >= T
and L lanes per rung, each lane a thread, with a barrier-backed shuffle in
place of ``__shfl_sync``; each lane makes its rung's x-free draws ahead in
groups, as the kernel does, but reads them from arrays (the padding
rungs' entries are NaN, so a padding lane that leaked into a rung would
show).  Every lane of a rung must end on that rung's state, and the
rungs' final states, the cold rung's sampling states and accepts and the
swap count must equal the loop's bit for bit.  The decisions are the
float32 ``((beta * (logp' - logp)) + logq) - logq'`` (independence) or
``beta * (logp' - logp)`` (walk) against ``logf(u)``, and ``logv <
dbeta_t * (logp_{t+1} - logp_t)`` for pair (t, t + 1) at steps of t's
parity, all strict.  The draws include the edge cases: ties of both
decisions (no move, no swap), a swap uniform of 0 (``logf(1e-38f)``, the
subnormal kept), the -100 log-pdf floor and -inf target densities.  The
adaptive walk's ``expf`` is the C library's in both.  Needs no JAX and no
GPU.
"""

import ctypes
import ctypes.util
import shutil
import subprocess

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch threads per xdist worker)

from tpu_montecarlo_torch.ops.build import CSRC
from tpu_montecarlo_torch.ops.mcmc_pt_kernel import rung_lanes

F32 = np.float32
_PAD = 64  # steps past a run's end: drawn by a tail group, never used
_LOG_SCALE = F32(13.815511)
_CUT = F32(2.75)  # the walk target's log density is -inf above it

_SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

static std::barrier<>* g_bar = nullptr;
static float g_table[32];
static thread_local int t_lane = 0;

// __shfl_sync(full mask, v, src, width) for lanes running as threads: src
// counts from the start of the caller's segment of `width` lanes.
static float host_shfl(float v, int src, int width) {
  g_table[t_lane] = v;
  g_bar->arrive_and_wait();
  const float r = g_table[t_lane / width * width + src % width];
  g_bar->arrive_and_wait();
  return r;
}
#define TMC_HOST_SHFL host_shfl

#include "mcmc_pipeline.cuh"

namespace {

constexpr float kCut = 2.75f;
constexpr float kLogScale = 13.815511f;

// Step i's draws of every rung, rows of T' (the lane's pair's lower rung
// indexes logv).
struct Draws {
  const float *z, *logu, *gamma, *logv, *cx, *clp, *clq;
  int stride;
};

struct WalkMake {
  const Draws& d;
  int rung;
  int lo_even, lo_odd;
  tmc::PtWalkDraw<1> operator()(uint32_t i) const {
    tmc::PtWalkDraw<1> w;
    w.z[0] = d.z[i * d.stride + rung];
    w.logu = d.logu[i * d.stride + rung];
    w.gamma = d.gamma[i];
    w.logv = d.logv[i * d.stride + ((i & 1u) ? lo_odd : lo_even)];
    return w;
  }
};

struct IndepMake {
  const Draws& d;
  int rung;
  int lo_even, lo_odd;
  tmc::PtCandidate<1> operator()(uint32_t i) const {
    tmc::PtCandidate<1> c;
    c.c.x[0] = d.cx[i * d.stride + rung];
    c.c.logp = d.clp[i * d.stride + rung];
    c.c.logq = d.clq[i * d.stride + rung];
    c.c.logu = d.logu[i * d.stride + rung];
    c.logv = d.logv[i * d.stride + ((i & 1u) ? lo_odd : lo_even)];
    return c;
  }
};

struct Target {
  float operator()(const float (&x)[1]) const {
    return x[0] > kCut ? -INFINITY : -0.5f * x[0] * x[0];
  }
};

struct Record {
  float* xs;
  uint8_t* acc;
  int n;
  void operator()(const float (&x)[1], bool accepted) {
    if (xs != nullptr) {
      xs[n] = x[0];
      acc[n] = accepted;
    }
    ++n;
  }
};

// Runs one chain of n_temps rungs on RL * L lanes (threads) in mode 0
// (independence), 1 (walk) or 2 (adaptive walk).  Writes each rung's final
// (x, logp, logq) to state (rows of 3), lane 0's sampling states and
// accepts, and counts[0..1] = the cold accepts, the swaps; returns 0 when
// every lane of a rung ends on the same state.
template <int RL, int L, int G>
int run(int mode, int n_temps, int n_burnin, int n_steps, const float* x0,
        const float* logp0, const float* logq0, const float* ladder,
        float step, float target_accept, const Draws& draws, float* xs,
        uint8_t* acc, float* state, float* counts) {
  constexpr int W = RL * L;
  std::barrier<> bar(W);
  g_bar = &bar;
  std::vector<float> lane_state(W * 3), lane_acc(W), lane_swaps(W);
  const uint32_t burn = uint32_t(n_burnin);
  const uint32_t end = burn + uint32_t(n_steps);
  std::vector<std::thread> lanes;
  for (int lane = 0; lane < W; ++lane) {
    lanes.emplace_back([&, lane] {
      t_lane = lane;
      const int rung = lane / L, l = lane % L;
      tmc::Rung<1> r;
      r.real = rung < n_temps;
      r.beta = r.real ? ladder[rung] : 0.0f;
      r.even = tmc::pair_lane<L>(rung, l, n_temps, 0, ladder + n_temps);
      r.odd = tmc::pair_lane<L>(rung, l, n_temps, 1, ladder + n_temps);
      r.swaps = 0.0f;
      r.x[0] = x0[rung];
      r.logp = logp0[rung];
      r.logq = logq0[rung];
      Record none{nullptr, nullptr, 0};
      Record rec{lane == 0 ? xs : nullptr, acc, 0};
      if (mode == 0) {
        const IndepMake make{draws, rung, r.even.lo, r.odd.lo};
        tmc::PtSelectStep<W, 1, Record> b{r, none};
        tmc::pipeline<L, G, tmc::PtCandidate<1>>(0u, burn, l, make, b);
        tmc::PtSelectStep<W, 1, Record> s{r, rec};
        tmc::pipeline<L, G, tmc::PtCandidate<1>>(burn, end, l, make, s);
      } else {
        const WalkMake make{draws, rung, r.even.lo, r.odd.lo};
        const Target target;
        const float steps[1] = {step};
        float eps[1] = {step};
        float log_scale = 0.0f;
        if (mode == 2) {
          tmc::PtWalkStep<W, 1, true, Target, Record> b{
              target, steps, target_accept, -kLogScale, kLogScale, r, eps,
              log_scale, none};
          tmc::pipeline<L, G, tmc::PtWalkDraw<1>>(0u, burn, l, make, b);
          eps[0] = expf(logf(expf(log_scale))) * step;
        } else {
          tmc::PtWalkStep<W, 1, false, Target, Record> b{
              target, steps, target_accept, -kLogScale, kLogScale, r, eps,
              log_scale, none};
          tmc::pipeline<L, G, tmc::PtWalkDraw<1>>(0u, burn, l, make, b);
        }
        tmc::PtWalkStep<W, 1, false, Target, Record> s{
            target, steps, target_accept, -kLogScale, kLogScale, r, eps,
            log_scale, rec};
        tmc::pipeline<L, G, tmc::PtWalkDraw<1>>(burn, end, l, make, s);
      }
      lane_state[lane * 3] = r.x[0];
      lane_state[lane * 3 + 1] = r.logp;
      lane_state[lane * 3 + 2] = r.logq;
      lane_swaps[lane] = r.swaps;
    });
  }
  for (auto& t : lanes) t.join();
  int differ = 0;
  for (int lane = 0; lane < W; ++lane) {
    const int first = lane / L * L;
    differ |= std::memcmp(&lane_state[lane * 3], &lane_state[first * 3],
                          3 * sizeof(float)) != 0;
  }
  for (int t = 0; t < RL; ++t) {
    std::memcpy(state + t * 3, &lane_state[t * L * 3], 3 * sizeof(float));
  }
  float swaps = 0.0f;
  for (int lane = 0; lane < W; ++lane) swaps += lane_swaps[lane];
  counts[1] = swaps;
  counts[0] = 0.0f;
  for (int s = 0; s < n_steps; ++s) counts[0] += acc[s];
  return differ;
}

template <int RL>
int run_layout(int lanes, int group, int mode, int n_temps, int n_burnin,
               int n_steps, const float* x0, const float* logp0,
               const float* logq0, const float* ladder, float step,
               float target_accept, const Draws& draws, float* xs,
               uint8_t* acc, float* state, float* counts) {
#define TMC_RUN(L, G)                                                     \
  if (lanes == L && group == G) {                                         \
    return run<RL, L, G>(mode, n_temps, n_burnin, n_steps, x0, logp0,     \
                         logq0, ladder, step, target_accept, draws, xs,   \
                         acc, state, counts);                             \
  }
  TMC_RUN(1, 1)
  TMC_RUN(1, 4)
  TMC_RUN(2, 3)
#undef TMC_RUN
  return -1;
}

}  // namespace

extern "C" int tmc_run_pt(int rung_lanes, int lanes, int group, int mode,
                          int n_temps, int n_burnin, int n_steps,
                          const float* x0, const float* logp0,
                          const float* logq0, const float* ladder, float step,
                          float target_accept, const float* z,
                          const float* logu, const float* gamma,
                          const float* logv, const float* cx,
                          const float* clp, const float* clq, float* xs,
                          uint8_t* acc, float* state, float* counts) {
  const Draws draws{z, logu, gamma, logv, cx, clp, clq, rung_lanes};
  switch (rung_lanes) {
    case 2: return run_layout<2>(lanes, group, mode, n_temps, n_burnin, n_steps, x0, logp0, logq0, ladder, step, target_accept, draws, xs, acc, state, counts);
    case 4: return run_layout<4>(lanes, group, mode, n_temps, n_burnin, n_steps, x0, logp0, logq0, ladder, step, target_accept, draws, xs, acc, state, counts);
    case 8: return run_layout<8>(lanes, group, mode, n_temps, n_burnin, n_steps, x0, logp0, logq0, ladder, step, target_accept, draws, xs, acc, state, counts);
  }
  return -1;
}

extern "C" float tmc_swap_logv(float v) { return tmc::swap_logv(v); }
"""


@pytest.fixture(scope="module")
def pt_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("pt_pipeline")
    (out / "shim.cpp").write_text(_SHIM)
    so = out / "libpt_pipeline.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared",
         "-fPIC", "-D__device__=", "-D__forceinline__=inline", "-I",
         str(CSRC), str(out / "shim.cpp"), "-o", str(so)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.tmc_run_pt.argtypes = (
        [ctypes.c_int] * 7 + [p] * 4 + [ctypes.c_float] * 2 + [p] * 11)
    lib.tmc_run_pt.restype = ctypes.c_int
    lib.tmc_swap_logv.argtypes = [ctypes.c_float]
    lib.tmc_swap_logv.restype = ctypes.c_float
    return lib


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
for _name in ("expf", "logf"):
    getattr(_LIBM, _name).argtypes = [ctypes.c_float]
    getattr(_LIBM, _name).restype = ctypes.c_float


def _expf(v):
    return F32(_LIBM.expf(float(v)))


def _minimum(a, b):  # tmc_minimum: NaN-propagating
    return F32(a + b) if (a != a or b != b) else (a if a < b else b)


def _maximum(a, b):
    return F32(a + b) if (a != a or b != b) else (a if a > b else b)


def _target(x):
    return F32(-np.inf) if x > _CUT else F32(F32(-0.5) * x) * x


class _Run:
    """One chain's inputs: ladder, initial rungs and every step's draws,
    rows of T' with NaN in the padding rungs' columns."""

    def __init__(self, mode, n_temps, n_burnin, n_steps, seed):
        rs = np.random.default_rng(seed)
        tl = rung_lanes(n_temps)
        n = n_burnin + n_steps + _PAD
        self.mode, self.n_temps, self.tl = mode, n_temps, tl
        self.n_burnin, self.n_steps = n_burnin, n_steps
        temps = np.geomspace(1.0, 3.0 * n_temps, n_temps)
        betas = 1.0 / temps
        self.ladder = np.concatenate(
            [betas, betas[:-1] - betas[1:]]).astype(F32)
        self.step, self.target_accept = F32(0.9), F32(0.44)

        def table(values):
            t = np.full((n, tl), np.nan, F32)
            t[:, :n_temps] = values[:, :n_temps]
            return t

        shape = (n, tl)
        self.z = table(rs.normal(0.0, 1.0, shape).astype(F32))
        self.logu = table(np.log(rs.uniform(0.0, 1.0, shape)).astype(F32))
        self.gamma = np.exp(-0.6 * np.log(np.arange(1, n + 1))).astype(F32)
        logv = np.log(rs.uniform(0.0, 1.0, shape)).astype(F32)
        self.v0 = F32(_LIBM.logf(1e-38))  # a swap uniform of 0
        logv[::29] = self.v0
        self.logv = table(logv)
        self.cx = table(rs.normal(0.0, 2.0, shape).astype(F32))
        self.clp = table((F32(-0.5) * self.cx * self.cx).astype(F32))
        self.clq = table(rs.normal(-2.0, 1.0, shape).astype(F32))
        self.logu[::11, :n_temps] = 0.0          # u = 1
        self.clp[3::13, :n_temps] = -100.0       # the log-pdf floor
        self.clq[5::17, :n_temps] = -100.0
        self.clp[7::19, :n_temps] = -np.inf      # a joint target's log(0)
        x0 = np.full(tl, np.nan, F32)
        if mode == 0:
            x0[:n_temps] = rs.normal(0.0, 2.0, n_temps)
            self.logp0 = (F32(-0.5) * x0 * x0).astype(F32)
            self.logq0 = np.full(tl, np.nan, F32)
            self.logq0[:n_temps] = rs.normal(-2.0, 1.0, n_temps)
            self.logp0[n_temps - 1] = -np.inf    # a rung that starts at -inf
        else:
            x0[:n_temps] = rs.uniform(-2.0, 2.0, n_temps)
            x0[n_temps - 1] = 3.0                 # above the cut: -inf
            self.logp0 = np.array([_target(v) for v in x0], F32)
            self.logq0 = np.where(np.isnan(x0), np.nan, 0.0).astype(F32)
        self.x0 = x0
        # Ties: at some steps, set the draws so that a rung's la equals
        # logf(u), and a pair's delta its logv.
        self.reference(ties=True)

    def reference(self, ties=False):
        """The ladder layout as a float32 loop: (cold xs, cold accepts,
        final rung states (T, 3), swaps).  With ``ties``, draws at every
        23rd step (moves) and 31st step (swaps) are overwritten first so
        that the decision ties."""
        T, mode = self.n_temps, self.mode
        beta, dbeta = self.ladder[:T], self.ladder[T:]
        x = self.x0[:T].copy()
        logp = self.logp0[:T].copy()
        logq = self.logq0[:T].copy()
        log_scale = np.zeros(T, F32)
        eps = np.full(T, self.step, F32)
        xs, accs, swaps = [], [], 0
        with np.errstate(invalid="ignore", over="ignore"):
            for i in range(self.n_burnin + self.n_steps):
                burn = i < self.n_burnin
                if mode == 2 and i == self.n_burnin:
                    eps = np.array([
                        F32(_expf(F32(_LIBM.logf(float(_expf(s))))) * self.step)
                        for s in log_scale], F32)
                accepted = np.zeros(T, bool)
                for t in range(T):
                    if mode == 0:
                        xp, lpp = self.cx[i, t], self.clp[i, t]
                        lqp = self.clq[i, t]
                        la = F32(F32(F32(beta[t] * F32(lpp - logp[t]))
                                     + logq[t]) - lqp)
                    else:
                        if mode == 2 and burn:
                            eps[t] = F32(_expf(log_scale[t]) * self.step)
                        xp = F32(x[t] + F32(eps[t] * self.z[i, t]))
                        lpp, lqp = _target(xp), F32(0.0)
                        la = F32(beta[t] * F32(lpp - logp[t]))
                    if ties and i % 23 == 2 and not np.isnan(la):
                        self.logu[i, t] = la
                    accepted[t] = bool(self.logu[i, t] < la)
                    if accepted[t]:
                        x[t], logp[t], logq[t] = xp, lpp, lqp
                    if mode == 2 and burn:
                        alpha_p = _expf(_minimum(la, F32(0.0)))
                        log_scale[t] = _minimum(_maximum(
                            F32(log_scale[t] + F32(self.gamma[i] * F32(
                                alpha_p - self.target_accept))),
                            -_LOG_SCALE), _LOG_SCALE)
                for t in range(i % 2, T - 1, 2):
                    delta = F32(dbeta[t] * F32(logp[t + 1] - logp[t]))
                    if ties and i % 31 == 4 and not np.isnan(delta):
                        self.logv[i, t] = delta
                    if self.logv[i, t] < delta:
                        x[[t, t + 1]] = x[[t + 1, t]]
                        logp[[t, t + 1]] = logp[[t + 1, t]]
                        logq[[t, t + 1]] = logq[[t + 1, t]]
                        swaps += 1
                if not burn:
                    xs.append(x[0])
                    accs.append(accepted[0])
        state = np.stack([x, logp, logq], axis=1).astype(F32)
        return np.array(xs, F32), np.array(accs, bool), state, swaps

    def run(self, lib, lanes, group):
        xs = np.zeros(self.n_steps, F32)
        acc = np.zeros(self.n_steps, np.uint8)
        state = np.zeros((self.tl, 3), F32)
        counts = np.zeros(2, F32)
        arrays = [self.x0, self.logp0, self.logq0, self.ladder]
        draws = [self.z, self.logu, self.gamma, self.logv, self.cx, self.clp,
                 self.clq]
        differ = lib.tmc_run_pt(
            self.tl, lanes, group, self.mode, self.n_temps, self.n_burnin,
            self.n_steps, *(a.ctypes.data for a in arrays), self.step,
            self.target_accept, *(a.ctypes.data for a in draws),
            xs.ctypes.data, acc.ctypes.data, state.ctypes.data,
            counts.ctypes.data,
        )
        return differ, xs, acc.astype(bool), state[:self.n_temps], counts


MODES = {"independence": 0, "walk": 1, "adaptive-walk": 2}
RUNS = [(0, 1), (5, 7), (0, 1201), (37, 250)]
LAYOUTS = [(1, 1), (1, 4), (2, 3)]  # (lanes per rung, group)


@pytest.mark.parametrize("n_burnin,n_steps", RUNS,
                         ids=[f"burn{b}-steps{s}" for b, s in RUNS])
@pytest.mark.parametrize("lanes,group", LAYOUTS,
                         ids=[f"L{lanes}-G{g}" for lanes, g in LAYOUTS])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_temps", [2, 3, 4, 5, 8])
def test_tempered_lanes_match_float32_ladder(pt_lib, n_temps, mode, lanes,
                                             group, n_burnin, n_steps):
    run = _Run(MODES[mode], n_temps, n_burnin, n_steps,
               seed=n_temps * 1000 + MODES[mode] * 100 + n_steps + lanes)
    differ, xs, acc, state, counts = run.run(pt_lib, lanes, group)
    assert differ == 0, "the lanes of a rung hold different states"
    want_xs, want_acc, want_state, want_swaps = run.reference()
    np.testing.assert_array_equal(acc, want_acc)
    np.testing.assert_array_equal(xs, want_xs)
    np.testing.assert_array_equal(state, want_state)
    assert counts[0] == want_acc.sum()
    assert counts[1] == want_swaps
    if n_steps >= 250:
        # The run moves and swaps, and holds the edge cases: ties, u = 1,
        # v = 0, the floor, -inf.
        assert 0 < want_acc.sum() < n_steps
        assert 0 < want_swaps < (n_burnin + n_steps) * (n_temps // 2)


def test_swap_uniform_of_zero_keeps_the_subnormal(pt_lib):
    # logf(max(0, 1e-38f)): 1e-38f is subnormal; flushed to zero it would
    # give -inf, and clamped to the least normal float -87.34.
    got = F32(pt_lib.tmc_swap_logv(0.0))
    assert got == F32(_LIBM.logf(1e-38)) and -87.5 < got < -87.49
    assert F32(pt_lib.tmc_swap_logv(0.5)) == F32(_LIBM.logf(0.5))
