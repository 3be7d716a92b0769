// Hamiltonian Monte Carlo's leapfrog move for the MCMC kernels (mcmc.cu
// over one dimension, mcmc_nd.cu over d, mcmc_pt.cu on each tempered
// rung, through log_pdf_grad.cuh and mcmc_pipeline.cuh's PtWalkStep).
//
// tmc::hmc_move is one HMC step from (x, logp, g = grad(x)) over D
// dimensions: L kick-drift-kick leapfrog steps of sizes eps_j from the
// momenta p0, then the energy-corrected log acceptance ratio
// (mcmc_pallas.py:795-832, mcmc_nd_pallas.py:593-626), a NaN ratio (a
// diverged trajectory) taken as -3.0e38, which rejects; a tempered rung
// scales the force and the log densities by its beta
// (mcmc_pt_pallas.py:465-500).  The gradients come from the caller's
// value_grad (log_pdf_grad.cuh's closed forms and table slopes, or a
// joint target's generated tmc_target_logpdf_grad).
//
// Float arithmetic only, so it also compiles on the host with
// g++ -D__device__= -D__forceinline__=inline -ffp-contract=off.
#pragma once

namespace tmc {

// What an HMC move proposes over D dimensions: the trajectory's end x',
// the target's gradient and log density there, and the log acceptance
// ratio.
template <int D>
struct HmcProposal {
  float x[D], g[D];
  float logp, log_alpha;
};

// One HMC move of L leapfrog steps from (x, logp), g0 = grad(x), with the
// momenta p0 and the steps eps (a diagonal mass matrix), under the force
// beta * grad (a tempered rung's beta; 1 untempered): each kick adds
// ((0.5f * beta) * eps_j) * g_j, each drift eps_j * p_j
// (mcmc_nd_pallas.py:600-610, mcmc_pt_pallas.py:472-483).
// value_grad(x, g) writes the gradient at x and returns the log density
// there; the trajectory's last call gives logp'.  log_alpha = (beta *
// logp' - 0.5f * |p'|^2) - (beta * logp - 0.5f * |p0|^2), the squares
// summed in dimension order; a NaN ratio is taken as -3.0e38.  The
// chain carries g: the JAX kernels recompute grad(x) at each step's start,
// the same function of the same x, which is the trajectory's last
// gradient when the step before accepted and the chain's g when it
// rejected, so a step evaluates L gradients where they evaluate L + 1.
template <int L, int D, class ValueGrad>
__device__ __forceinline__ HmcProposal<D> hmc_move(
    const float (&x)[D], float logp, const float (&g0)[D],
    const float (&p0)[D], const float (&eps)[D], float beta,
    const ValueGrad& value_grad) {
  HmcProposal<D> h;
  float half[D], p[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    half[j] = (0.5f * beta) * eps[j];
    h.x[j] = x[j];
    h.g[j] = g0[j];
    p[j] = p0[j];
  }
  h.logp = logp;
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = p[j] + half[j] * h.g[j];
#pragma unroll
    for (int j = 0; j < D; ++j) h.x[j] = h.x[j] + eps[j] * p[j];
    h.logp = value_grad(h.x, h.g);
#pragma unroll
    for (int j = 0; j < D; ++j) p[j] = p[j] + half[j] * h.g[j];
  }
  float kin0 = p0[0] * p0[0], kin = p[0] * p[0];
#pragma unroll
  for (int j = 1; j < D; ++j) {
    kin0 = kin0 + p0[j] * p0[j];
    kin = kin + p[j] * p[j];
  }
  h.log_alpha = (beta * h.logp - 0.5f * kin) - (beta * logp - 0.5f * kin0);
  if (h.log_alpha != h.log_alpha) h.log_alpha = -3.0e38f;
  return h;
}

}  // namespace tmc
