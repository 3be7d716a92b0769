"""Split-R-hat, ESS and thinned draws of the three MCMC kernels: what the
plain versions add to their sampling phase, the four diagnostic rows per
block, and their recombination into ``(r_hat, ess)``.

Port of ``tpu_montecarlo/ops/mcmc_pallas.py:292-363`` (``_splithalf_add``,
``_diag_stat_rows``, ``_diag_combine``) and
``tpu_montecarlo/ops/mcmc_xla.py:51-87`` (``split_rhat_ess``), in float32
throughout.  A chain's sampling phase splits into two halves of ``n1 =
n_steps // 2`` steps (an odd last step is in neither); each half is a
sequence, and its statistics are those of the pilot-shifted values the
chain's sums add.  A block of ``CHAIN_THREADS`` chains reduces its 64
sequences to four rows, as a JAX program reduces its own: the sum of the
sequence means (pilot restored), their SS around the block's centroid,
that centroid, and the summed within-sequence variance.  Chan's formula
recombines the blocks exactly, so only float32 rounding differs from the
JAX kernels' per-program rows.

Thinned draws are the post-step states at sampling steps ``j * (n_steps
// m)``, ``j < m`` (the tempered kernel's: the cold rung's, after the
exchange).  Neither output changes a decision or the order in which a
chain's sums are added, so the values and error bars are those of a run
without them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "DIAG_ROWS",
    "PhaseOutputs",
    "check_outputs",
    "diag_combine",
    "split_rhat_ess",
]

#: Rows a diagnostics run adds to each block's three.
DIAG_ROWS = 4
#: Chains per block of the port's kernels (ops/mcmc_kernel.py:
#: CHAIN_THREADS), so sequences per block are twice that.
_BLOCK = 32


def check_outputs(n_steps: int, with_diagnostics: bool, samples: int) -> None:
    """The JAX kernels' checks of the two outputs (mcmc_pallas.py:531-546)."""
    if with_diagnostics and n_steps < 4:
        raise ValueError("with_diagnostics needs n_steps >= 4")
    if samples and not 1 <= int(samples) <= n_steps:
        raise ValueError(
            f"with_samples must be in [1, n_steps={n_steps}], got {samples}"
        )


def split_rhat_ess(
    w_tot: torch.Tensor, ss_tot: torch.Tensor, m_total: int, n1: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-R-hat and ESS from reduced split-half statistics, float32
    (``mcmc_xla.py:51-87``): ``w_tot`` sums the m_total sequences'
    within-sequence variances, ``ss_tot`` is the SS of the sequence means
    around their mean, ``n1`` the draws per sequence.  R = sqrt(var+/W),
    var+ = (n1 - 1)/n1 W + var(means); ESS = m var+/var(means), capped at
    the m n1 draws.  W == 0 reads +inf when the means differ (frozen at
    different values) and 1 when they are all equal (constant)."""
    m = np.float32(m_total)
    w = w_tot / float(m)
    var_means = ss_tot / float(max(m - np.float32(1.0), np.float32(1.0)))
    n1f = np.float32(max(int(n1), 1))
    var_plus = float((n1f - np.float32(1.0)) / n1f) * w + var_means
    r = torch.sqrt(var_plus / torch.clamp(w, min=1e-30))
    inf, one = torch.full_like(r, float("inf")), torch.ones_like(r)
    r = torch.where(w > 0, r, torch.where(var_means > 0, inf, one))
    total = float(m * n1f)
    ess = float(m) * var_plus / torch.clamp(var_means, min=1e-30)
    ess = torch.where(var_means > 0, torch.clamp(ess, max=total),
                      torch.full_like(ess, total))
    return r, ess


def diag_combine(rows: torch.Tensor, chains_actual: int, n_steps: int,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(r_hat, ess)``, (K,) float32 on the rows' device, from the blocks'
    diagnostic rows 3-6 (``mcmc_pallas.py:343-363``): the sequence means'
    SS recombined around their global mean by Chan's formula, then
    :func:`split_rhat_ess` over the ``2 * chains_actual`` sequences."""
    seq_sums, seq_ss, seq_mb, w = (rows[:, 3 + r, :k] for r in range(4))
    chains_f = np.float32(chains_actual)
    m_seq = seq_sums.sum(dim=0) / float(np.float32(2.0) * chains_f)
    corr = float(2 * _BLOCK) * (seq_mb - m_seq) ** 2
    ss_tot = (seq_ss + corr).sum(dim=0)
    return split_rhat_ess(w.sum(dim=0), ss_tot, 2 * chains_actual,
                          n_steps // 2)


class PhaseOutputs:
    """What a plain version's sampling phase adds besides the sums, step by
    step in the kernels' order: per chain the two halves' sums and squares
    of the pilot-shifted values, and the thinned draws.  ``add`` takes the
    sampling step ``t`` (0 for the first), the values the chains' sums add
    and the post-step state."""

    def __init__(self, n_steps: int, with_diagnostics: bool, samples: int,
                 k: int, like: torch.Tensor):
        self.n1 = n_steps // 2 if with_diagnostics else 0
        self.m = int(samples)
        self.stride = n_steps // self.m if self.m else 0
        zero = torch.zeros_like(like)
        self.sums = [[zero] * k, [zero] * k]
        self.squares = [[zero] * k, [zero] * k]
        self.draws: List[torch.Tensor] = []

    def add(self, t: int, vals: Sequence[torch.Tensor], x) -> None:
        if t < 2 * self.n1:
            h = t // self.n1
            self.sums[h] = [a + v for a, v in zip(self.sums[h], vals)]
            self.squares[h] = [a + v * v
                               for a, v in zip(self.squares[h], vals)]
        if self.m and t % self.stride == 0 and t // self.stride < self.m:
            self.draws.append(x)

    def rows(self, pilots: torch.Tensor, width: int) -> Optional[torch.Tensor]:
        """The blocks' four diagnostic rows of ``width`` floats (zeros past
        the K values), from each chain's pilots (C, K); None without
        diagnostics.  The kernels' order (mcmc_pipeline.cuh end_half,
        write_diag_rows): per half the block's sums of m = s / n1, m^2 and
        the squares, the second half's added to the first's."""
        if not self.n1:
            return None

        def per_chain(ts):
            return torch.stack([t.reshape(-1) for t in ts], dim=1)

        def block_sum(t):
            return t.reshape(-1, _BLOCK, t.shape[1]).sum(dim=1)

        n1f = np.float32(self.n1)
        inv_n1 = float(np.float32(1.0) / n1f)
        means = [per_chain(s) * inv_n1 for s in self.sums]
        s_m = block_sum(means[0]) + block_sum(means[1])
        s_msq = block_sum(means[0] * means[0]) + block_sum(means[1] * means[1])
        s_q = (block_sum(per_chain(self.squares[0]))
               + block_sum(per_chain(self.squares[1])))
        w = (s_q - float(n1f) * s_msq) / float(max(self.n1 - 1, 1))
        n_seq = float(2 * _BLOCK)
        mbs = s_m / n_seq
        ss = torch.clamp(s_msq - n_seq * mbs * mbs, min=0.0)
        mb = mbs + pilots.reshape(-1, _BLOCK, pilots.shape[1])[:, 0, :]
        out = torch.stack([n_seq * mb, ss, mb, w], dim=1)
        return torch.nn.functional.pad(out, (0, width - out.shape[2]))

    def samples(self) -> Optional[torch.Tensor]:
        """The draws, (m, chains) from a 1-D state and (m, d, chains) from
        a list of d state blocks; None without them."""
        if not self.m:
            return None
        if isinstance(self.draws[0], torch.Tensor):
            return torch.stack([x.reshape(-1) for x in self.draws])
        return torch.stack([torch.stack([x.reshape(-1) for x in xs])
                            for xs in self.draws])
