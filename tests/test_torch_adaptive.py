"""VEGAS-style adaptive importance sampling (``adapt_proposal``,
``tpu_montecarlo_torch/adaptive.py``) against the JAX package's
(``tpu_montecarlo/adaptive.py``), and the profiling helpers
(``utils/profiling.py``).

* The host grid rebuild and the learned proposal's table,
  ``_rebuild_edges`` and ``_proposal_from_edges``, bit for bit against
  the JAX package's on the same inputs.
* The cases of ``tests/test_adaptive.py`` on the port at their sizes and
  tolerances, on the CPU (the plain versions): the variance reduction
  (peaked bump, rare tail, nd bump), grid mechanics, history, a CUSTOM
  target, a zero integrand, the IS diagnostics, qmc, the mean weight,
  error bars and methods, the nd proposal on the nd kernel's sampler
  route, validation.  The two mesh cases wait for ROADMAP item 12.  The
  adaptation's uniforms are the port's counter stream and the JAX
  package's ``jax.random``: the two learn different grids, each held to
  the closed forms, and the JAX package's learned proposal also runs the
  port's importance sampling within the same tolerances.
* The learned proposal takes kernel 1's CUSTOM "strata" route with the
  sampler's own density as q (``SAMPLER``), and nd the same per
  dimension.
"""

import math
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo import adaptive as jad

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch import adaptive as tad
from tpu_montecarlo_torch.ops.integrate_kernel import SAMPLER
from tpu_montecarlo_torch.sampling import DistKind, dist_spec_of

CPU = tm.MonteCarloIntegrator(device="cpu")
TARGET = tm.Distribution.normal(0.0, 2.0)


def bump(x):
    return math.exp(-200.0 * (x - 1.0) ** 2)


BUMP_TRUTH = (
    math.sqrt(math.pi / 200.0)
    * math.exp(-0.5 * (1.0 / 2.0) ** 2)
    / (2.0 * math.sqrt(2.0 * math.pi))
)


def _bump2(x, y):
    return math.exp(-200.0 * ((x - 1.0) ** 2 + (y + 0.5) ** 2))


BUMP2_TRUTH = (
    (math.pi / 200.0)
    * (math.exp(-0.5 * 0.25) / (2.0 * math.sqrt(2.0 * math.pi)))
    * (math.exp(-0.5 * 0.0625) / (2.0 * math.sqrt(2.0 * math.pi)))
)


def _adapt(*args, **kwargs):
    return tm.adapt_proposal(*args, device="cpu", **kwargs)


def _is(fns, target, proposal, **kwargs):
    return CPU.integrate_importance_sampling(fns, target, proposal, **kwargs)


@pytest.fixture(scope="module")
def bump_proposal():
    return _adapt(bump, TARGET, n_iterations=6, seed=7)


# -- the host pieces, bit for bit ---------------------------------------------------


def test_rebuild_edges_bit_for_bit():
    rs = np.random.default_rng(5)
    for n_bins, alpha in ((256, 1.5), (64, 0.5), (3, 2.0), (2, 1.5)):
        edges = np.sort(rs.uniform(-4.0, 4.0, n_bins + 1))
        for d_sq in (rs.exponential(1.0, n_bins) ** 3,
                     np.where(rs.random(n_bins) < 0.8, 0.0, 1.0),
                     np.zeros(n_bins),
                     np.float32(rs.random(n_bins)).astype(np.float64)):
            got = tad._rebuild_edges(edges, d_sq, alpha)
            want = jad._rebuild_edges(edges, d_sq, alpha)
            np.testing.assert_array_equal(got, want)


def test_proposal_from_edges_bit_for_bit():
    rs = np.random.default_rng(8)
    edges = np.sort(np.concatenate([[-8.0, 8.0], rs.uniform(-8, 8, 255)]))
    edges[100:110] = np.linspace(edges[100], edges[100] + 1e-6, 10)
    got = tad._proposal_from_edges(edges)
    want = jad._proposal_from_edges(edges)
    np.testing.assert_array_equal(got._x_table, want._x_table)
    np.testing.assert_array_equal(got._cdf_table, want._cdf_table)
    np.testing.assert_array_equal(got.get_or_compute_pdf_table()[1],
                                  want.get_or_compute_pdf_table()[1])


def test_support_of_matches_jax():
    for t, jt in ((TARGET, jmc.Distribution.normal(0.0, 2.0)),
                  (tm.Distribution.gumbel(1.0, 0.5),
                   jmc.Distribution.gumbel(1.0, 0.5))):
        assert tad._support_of(t) == pytest.approx(jad._support_of(jt),
                                                   rel=1e-12)


# -- the JAX package's cases on the port -----------------------------------------------


def test_peaked_bump(bump_proposal):
    n = 2_000_000
    naive = _is([bump], TARGET, tm.Distribution.normal(0.0, 2.0),
                n_samples=n, seed=1, return_stderr=True)
    adapted = _is([bump], TARGET, bump_proposal, n_samples=n, seed=1,
                  return_stderr=True)
    assert abs(adapted.values[0] - BUMP_TRUTH) < 5e-4
    assert (naive.stderr[0] / adapted.stderr[0]) ** 2 > 20.0


def test_rare_tail_port_and_jax_proposals():
    """P(N(0,1) > 4) from the port's learned proposal and from the JAX
    package's (its tables through the port's Distribution), each by the
    port's importance sampling: within 5 % and an error bar below the
    naive 4e-6."""
    target = tm.Distribution.normal(0.0, 1.0)

    def tail(x):
        return 1.0 if x > 4.0 else 0.0

    q = _adapt(tail, target, n_iterations=8, seed=9, support=(-8.0, 8.0))
    jq = jad.adapt_proposal(tail, jmc.Distribution.normal(0.0, 1.0),
                            n_iterations=8, seed=9, support=(-8.0, 8.0))
    jq_port = tm.Distribution.from_pdf_table(
        jq._x_table, jq.get_or_compute_pdf_table()[1])
    truth = 3.16712e-05
    for proposal in (q, jq_port):
        r = _is([tail], target, proposal, n_samples=2_000_000, seed=2,
                return_stderr=True)
        assert abs(r.values[0] - truth) < 0.05 * truth
        assert r.stderr[0] < 4e-7


def test_nd_bump():
    def bump2(x, y):
        return math.exp(-50.0 * ((x - 1.0) ** 2 + (y + 1.0) ** 2))

    targets = [tm.Distribution.normal(0.0, 2.0)] * 2
    q = _adapt(bump2, targets, n_iterations=6, seed=11)
    assert isinstance(q, list) and len(q) == 2
    n = 2_000_000
    adapted = _is([bump2], targets, q, n_samples=n, seed=3,
                  return_stderr=True)
    naive = _is([bump2], targets, targets, n_samples=n, seed=3,
                return_stderr=True)
    assert (naive.stderr[0] / adapted.stderr[0]) ** 2 > 20.0
    assert abs(adapted.values[0] - naive.values[0]) < 1e-4


def test_history_stderr_falls():
    _, hist = _adapt(bump, TARGET, n_iterations=6, seed=7,
                     return_history=True)
    assert len(hist["estimate"]) == 6 and len(hist["stderr"]) == 6
    assert hist["stderr"][-1] < 0.1 * hist["stderr"][0]
    assert abs(hist["estimate"][-1] - BUMP_TRUTH) < 5e-4
    # The port's addition: the final edges, monotone over the support.
    (edges,) = hist["edges"]
    assert len(edges) == 257 and np.all(np.diff(edges) >= 0)


def test_proposal_is_valid_distribution(bump_proposal):
    x = np.asarray(bump_proposal._x_table)
    assert np.all(np.diff(x) > 0)
    assert x[0] == pytest.approx(TARGET.quantile(1e-5), abs=1e-3)
    assert x[-1] == pytest.approx(TARGET.quantile(1 - 1e-5), abs=1e-3)
    cdf = np.asarray(bump_proposal._cdf_table, np.float64)
    assert cdf[-1] == pytest.approx(1.0, abs=1e-5)


def test_grid_concentrates_on_the_bump(bump_proposal):
    x = np.asarray(bump_proposal._x_table)
    assert np.mean(np.abs(x - 1.0) < 0.5) > 0.5


def test_custom_table_target():
    target = tm.Distribution.from_pdf(
        lambda x: np.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi),
        support=(-6.0, 6.0),
    )
    q = _adapt(bump, target, n_iterations=5, seed=13)
    r = _is([bump], target, q, n_samples=1_000_000, seed=4,
            return_stderr=True)
    truth = math.sqrt(math.pi / 200.0) * math.exp(-0.5) / math.sqrt(
        2.0 * math.pi)
    assert abs(r.values[0] - truth) < 10.0 * max(r.stderr[0], 1e-5)


def test_zero_integrand_keeps_grid():
    def zero(x):
        return 0.0 * x

    q = _adapt(zero, TARGET, n_iterations=3, seed=15, grid_size=64)
    w = np.diff(np.asarray(q._x_table))
    big = w[w > w.max() * 0.5]
    assert len(big) == 64
    assert np.allclose(big, big[0], rtol=1e-3)


def test_is_diagnostics_ess(bump_proposal):
    r = _is([bump], TARGET, bump_proposal, n_samples=1_000_000, seed=5,
            return_diagnostics=True)
    assert r.diagnostics["mean_weight"] == pytest.approx(1.0, abs=0.05)
    assert r.diagnostics["ess"] > 0


def test_qmc_with_adapted_proposal(bump_proposal):
    r = _is([bump], TARGET, bump_proposal, n_samples=1_000_000, seed=6,
            method="qmc")
    assert abs(r.values[0] - BUMP_TRUTH) < 5e-4


def test_learned_table_takes_the_sampler_route(bump_proposal):
    """Kernel 1's CUSTOM "strata" route, q the sampler's own density
    (the JAX package's round-4 sampler mode), p traced."""
    spec = dist_spec_of(bump_proposal)
    assert spec.kind == DistKind.CUSTOM and not spec.exact_inverse
    p, q = CPU._is_weight(TARGET, bump_proposal)
    assert q is SAMPLER and isinstance(p, tm.tracing.TracedFunction)
    r = _is([bump], TARGET, bump_proposal, n_samples=1_000_000, seed=2)
    assert abs(r.values[0] - BUMP_TRUTH) < 2e-4


def test_mean_weight_is_one(bump_proposal):
    r = _is([lambda x: 1.0], TARGET, bump_proposal, n_samples=2_000_000,
            seed=5)
    assert abs(r.values[0] - 1.0) < 0.02


def test_stderr_and_methods_compose(bump_proposal):
    r = _is([bump], TARGET, bump_proposal, n_samples=1_000_000, seed=4,
            return_stderr=True)
    assert r.stderr is not None and r.stderr[0] > 0
    assert abs(r.values[0] - BUMP_TRUTH) < 6 * float(r.stderr[0])
    for method in ("antithetic", "qmc"):
        rm = _is([bump], TARGET, bump_proposal, n_samples=1_000_000, seed=4,
                 method=method)
        assert abs(rm.values[0] - BUMP_TRUTH) < 2e-4


def test_nd_learned_proposal_rides_the_nd_kernel():
    t2 = [tm.Distribution.normal(0.0, 2.0)] * 2
    q2 = _adapt(_bump2, t2, seed=7)
    assert all(CPU._is_weight_dim(t, q)[1] is SAMPLER for t, q in zip(t2, q2))
    r = _is([_bump2], t2, q2, n_samples=2_000_000, seed=3)
    assert abs(r.values[0] - BUMP2_TRUTH) / BUMP2_TRUTH < 0.02
    r2 = _is([_bump2], t2, q2, n_samples=1_000_000, seed=4,
             return_stderr=True, return_diagnostics=True)
    assert r2.stderr[0] > 0
    assert abs(r2.values[0] - BUMP2_TRUTH) < 8 * float(r2.stderr[0])
    assert r2.diagnostics["ess"] > 0
    r3 = _is([_bump2], t2, [q2[0], tm.Distribution.normal(-0.5, 0.3)],
             n_samples=2_000_000, seed=5)
    assert abs(r3.values[0] - BUMP2_TRUTH) / BUMP2_TRUTH < 0.03


def test_jax_proposal_on_the_port_matches_the_closed_form():
    """The JAX package's learned bump proposal, through the port's
    importance sampling: the same tolerance as the port's own."""
    jq = jad.adapt_proposal(bump, jmc.Distribution.normal(0.0, 2.0),
                            n_iterations=6, seed=7)
    q = tm.Distribution.from_pdf_table(jq._x_table,
                                       jq.get_or_compute_pdf_table()[1])
    r = _is([bump], TARGET, q, n_samples=1_000_000, seed=4,
            return_stderr=True)
    assert abs(r.values[0] - BUMP_TRUTH) < 6 * float(r.stderr[0])
    assert abs(r.values[0] - BUMP_TRUTH) < 5e-4


class TestValidation:
    def test_bad_target_type(self):
        with pytest.raises(TypeError):
            _adapt(bump, "not a distribution")

    def test_bad_support(self):
        with pytest.raises(ValueError, match="support"):
            _adapt(bump, TARGET, support=(3.0, 1.0))

    def test_support_dim_mismatch(self):
        with pytest.raises(ValueError, match="dimension"):
            _adapt(bump, TARGET, support=[(0.0, 1.0), (0.0, 1.0)])

    @pytest.mark.parametrize("kwargs", [
        dict(n_iterations=0), dict(grid_size=1),
        dict(n_samples=10, grid_size=256), dict(alpha=0.0)])
    def test_bad_counts_word_for_word(self, kwargs):
        with pytest.raises(ValueError) as port:
            _adapt(bump, TARGET, **kwargs)
        with pytest.raises(ValueError) as jax_e:
            jad.adapt_proposal(bump, jmc.Distribution.normal(0.0, 2.0),
                               **kwargs)
        assert str(port.value) == str(jax_e.value)


# -- the profiling helpers --------------------------------------------------------


def test_timed_records_seconds():
    with tm.timed("block") as t:
        sum(range(1000))
    assert t["label"] == "block" and t["seconds"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tm.trace(str(tmp_path / "tr")):
        CPU.integrate([lambda x: x], TARGET, n_samples=1 << 15)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "tr" / files[0]) > 0


def test_measure_throughput_syncs_every_output():
    calls = []

    def fn(rep):
        calls.append(rep)
        return (torch.full((4,), float(rep)), [torch.zeros(2)],
                {"n": np.ones(3)})

    rate = tm.measure_throughput(fn, work_per_call=100, repeats=3, warmup=2)
    assert rate > 0 and calls == [0, 1, 2, 3, 4]
