"""The port's ``pack_*`` functions and batch-argument checks against the
JAX package's (``tpu_montecarlo/api/batching.py``).

Each pack function packs the same Distributions and walks into the same float32
arrays, bit for bit, with the same family tags; every ``ValueError`` and
``TypeError`` of the pack functions and of a param-batched handle's argument
checks has the JAX package's type and words, fed the same bad inputs.
Host code only: nothing here launches a kernel.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads per xdist worker)

import tpu_montecarlo as jmc
from tpu_montecarlo.api import batching as jb

import tpu_montecarlo_torch as tm
from tpu_montecarlo_torch.api import batching as tb

# Two rows of every closed-form family, as (factory, params) pairs.
FAMILY_ROWS = {
    "uniform": [(-1.0, 2.0), (0.5, 4.0)],
    "normal": [(0.5, 1.5), (-2.0, 0.25)],
    "exponential": [(2.0,), (0.5,)],
    "lognormal": [(0.0, 0.5), (0.3, 1.7)],
    "cauchy": [(0.0, 1.0), (0.3, 1.7)],
    "laplace": [(3.0, 1.0), (-0.7, 0.3)],
    "logistic": [(0.0, 2.0), (1.3, 0.6)],
    "gumbel": [(1.0, 0.5), (-2.0, 3.0)],
    "weibull": [(1.5, 2.0), (0.5, 1.0)],
    "pareto": [(1.0, 3.0), (0.5, 1.2)],
}


def _dists(pkg, name):
    return [getattr(pkg.Distribution, name)(*p) for p in FAMILY_ROWS[name]]


def _same(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_error(call):
    """Both packages raise the same type with the same words (a type named
    in the message by its own package's module)."""
    with pytest.raises(Exception) as want:
        call(jmc, jb)
    with pytest.raises(type(want.value)) as got:
        call(tm, tb)
    assert str(got.value).replace("tpu_montecarlo_torch.", "tpu_montecarlo.") \
        == str(want.value)


def test_exports_match_the_jax_package():
    for name in ("pack_param_batch", "pack_param_batch_nd",
                 "pack_random_walk_batch", "pack_random_walk_batch_nd"):
        assert getattr(tm, name) is getattr(tb, name)
        assert name in tm.__all__ and name in jmc.__all__
        from tpu_montecarlo_torch import api
        assert getattr(api, name) is getattr(tb, name)


@pytest.mark.parametrize("name", list(FAMILY_ROWS))
def test_pack_param_batch_bit_equal(name):
    got = tm.pack_param_batch(_dists(tm, name))
    want = jmc.pack_param_batch(_dists(jmc, name))
    _same(got, want)
    assert int(got.family) == int(want.family)
    assert got.shape == (2, 2)
    # The tag survives a slice, as the JAX pack's does.
    assert int(got[:1].family) == int(want[:1].family)


def test_pack_param_batch_nd_bit_equal():
    rows = [("normal", "uniform", "gumbel"), ("normal", "uniform", "gumbel")]

    def pack(pkg):
        return pkg.pack_param_batch_nd(
            [[_dists(pkg, n)[r] for n in row] for r, row in enumerate(rows)])

    got, want = pack(tm), pack(jmc)
    _same(got, want)
    assert got.shape == (2, 3, 2)
    assert tuple(int(f) for f in got.families) == tuple(
        int(f) for f in want.families)


WALKS = {
    "fixed": lambda pkg: [pkg.RandomWalk(step_size=s) for s in (0.5, 1.0, 2.0)],
    "adaptive": lambda pkg: [pkg.RandomWalk(step_size=s, adapt=True,
                                            target_accept=a)
                             for s, a in ((0.5, 0.3), (1.0, 0.44), (2.0, 0.6))],
    "init-range": lambda pkg: [pkg.RandomWalk(step_size=1.0,
                                              init_range=(-1.0, 1.0 + r))
                               for r in range(3)],
    "hmc": lambda pkg: [pkg.HMC(step_size=s, n_leapfrog=4) for s in
                        (0.2, 0.3, 0.4)],
}


@pytest.mark.parametrize("walks", list(WALKS))
def test_pack_random_walk_batch_bit_equal(walks):
    targets = {pkg: [pkg.Distribution.normal(0.0, 1.0 + r) for r in range(3)]
               for pkg in (tm, jmc)}
    for target in (lambda pkg: targets[pkg][0], lambda pkg: targets[pkg]):
        got = tm.pack_random_walk_batch(WALKS[walks](tm), target(tm))
        want = jmc.pack_random_walk_batch(WALKS[walks](jmc), target(jmc))
        _same(got, want)
        assert got.family == want.family
        assert got.shape == (3, 4)
    if walks == "init-range":
        _same(tm.pack_random_walk_batch(WALKS[walks](tm)),
              jmc.pack_random_walk_batch(WALKS[walks](jmc)))


@pytest.mark.parametrize("walks", list(WALKS))
def test_pack_random_walk_batch_nd_bit_equal(walks):
    def dims(pkg, r=0):
        return [pkg.Distribution.normal(0.0, 1.0 + r),
                pkg.Distribution.exponential(2.0)]

    shared_got = tm.pack_random_walk_batch_nd(WALKS[walks](tm), dims(tm))
    shared_want = jmc.pack_random_walk_batch_nd(WALKS[walks](jmc), dims(jmc))
    _same(shared_got, shared_want)
    assert shared_got.family == shared_want.family
    assert shared_got.shape == (3, 2, 4)
    per_got = tm.pack_random_walk_batch_nd(WALKS[walks](tm),
                                           [dims(tm, r) for r in range(3)])
    per_want = jmc.pack_random_walk_batch_nd(WALKS[walks](jmc),
                                             [dims(jmc, r) for r in range(3)])
    _same(per_got, per_want)
    if walks == "init-range":
        _same(tm.pack_random_walk_batch_nd(WALKS[walks](tm), d=2),
              jmc.pack_random_walk_batch_nd(WALKS[walks](jmc), d=2))


def _n(pkg, *a):
    return pkg.Distribution.normal(*a)


def _u(pkg, *a):
    return pkg.Distribution.uniform(*a)


PACK_ERRORS = {
    "empty": lambda pkg, b: b.pack_param_batch([]),
    "mixed-families": lambda pkg, b: b.pack_param_batch(
        [_n(pkg, 0, 1), _u(pkg, 0, 1)]),
    "custom": lambda pkg, b: b.pack_param_batch(
        [pkg.Distribution.beta(2.0, 5.0)]),
    "nd-empty": lambda pkg, b: b.pack_param_batch_nd([]),
    "nd-empty-row": lambda pkg, b: b.pack_param_batch_nd([[]]),
    "nd-ragged": lambda pkg, b: b.pack_param_batch_nd(
        [[_n(pkg, 0, 1), _n(pkg, 0, 1)], [_n(pkg, 0, 1)]]),
    "nd-mixed": lambda pkg, b: b.pack_param_batch_nd(
        [[_n(pkg, 0, 1), _u(pkg, 0, 1)], [_n(pkg, 0, 1), _n(pkg, 0, 1)]]),
    "nd-custom": lambda pkg, b: b.pack_param_batch_nd(
        [[_n(pkg, 0, 1), pkg.Distribution.beta(2.0, 5.0)]]),
    "rw-empty": lambda pkg, b: b.pack_random_walk_batch([], _n(pkg, 0, 1)),
    "rw-not-a-walk": lambda pkg, b: b.pack_random_walk_batch(
        [_n(pkg, 0, 1)], _n(pkg, 0, 1)),
    "rw-mixed-adapt": lambda pkg, b: b.pack_random_walk_batch(
        [pkg.RandomWalk(), pkg.RandomWalk(adapt=True)], _n(pkg, 0, 1)),
    "rw-target-count": lambda pkg, b: b.pack_random_walk_batch(
        [pkg.RandomWalk()] * 2, [_n(pkg, 0, 1)] * 3),
    "rw-nd-not-a-walk": lambda pkg, b: b.pack_random_walk_batch_nd(
        [_n(pkg, 0, 1)], [_n(pkg, 0, 1)]),
    "rw-nd-mixed-dims": lambda pkg, b: b.pack_random_walk_batch_nd(
        [pkg.RandomWalk()] * 2, [[_n(pkg, 0, 1)], [_n(pkg, 0, 1)] * 2]),
    "rw-nd-no-d": lambda pkg, b: b.pack_random_walk_batch_nd(
        [pkg.RandomWalk(init_range=(0.0, 1.0))]),
    "rw-nd-wrong-d": lambda pkg, b: b.pack_random_walk_batch_nd(
        [pkg.RandomWalk()], [_n(pkg, 0, 1)] * 2, d=3),
}


@pytest.mark.parametrize("case", list(PACK_ERRORS))
def test_pack_errors_word_for_word(case):
    _same_error(PACK_ERRORS[case])


def _pack(pkg, name):
    return pkg.pack_param_batch(_dists(pkg, name))


def _rw(pkg, adapt=False):
    return pkg.pack_random_walk_batch(
        [pkg.RandomWalk(adapt=adapt)] * 2, _n(pkg, 0, 1))


def _args(pkg, b, seeds, params, r=2, n=1, kinds=()):
    if b is jb:
        return b._check_param_batch_args(seeds, params, r, n, kinds)
    return b._check_param_batch_args(seeds, params, r, n, kinds, "cpu")


NORMAL = int(jmc.sampling.DistKind.NORMAL)
UNIFORM = int(jmc.sampling.DistKind.UNIFORM)
CHECK_ERRORS = {
    "seed-count": lambda pkg, b: _args(pkg, b, [1, 2, 3], (_pack(pkg, "normal"),)),
    "seed-shape": lambda pkg, b: _args(pkg, b, [[1, 2]], (_pack(pkg, "normal"),)),
    "params-count": lambda pkg, b: _args(pkg, b, [1, 2], ()),
    "params-shape": lambda pkg, b: _args(pkg, b, [1, 2],
                                         (np.zeros((3, 2), np.float32),)),
    "other-family": lambda pkg, b: _args(pkg, b, [1, 2], (_pack(pkg, "uniform"),),
                                         kinds=(NORMAL,)),
    "walk-in-a-density-slot": lambda pkg, b: _args(pkg, b, [1, 2], (_rw(pkg),),
                                                   kinds=(NORMAL,)),
    "density-in-a-walk-slot": lambda pkg, b: _args(
        pkg, b, [1, 2], (_pack(pkg, "normal"),), kinds=("rw",)),
    "fixed-walk-in-an-adaptive-slot": lambda pkg, b: _args(
        pkg, b, [1, 2], (_rw(pkg),), kinds=("rw_adapt",)),
    "walk-width": lambda pkg, b: _args(pkg, b, [1, 2],
                                       (np.zeros((2, 2), np.float32),),
                                       kinds=("rw",)),
    "second-slot": lambda pkg, b: _args(
        pkg, b, [1, 2], (_pack(pkg, "normal"), _pack(pkg, "normal")), n=2,
        kinds=(NORMAL, UNIFORM)),
}


@pytest.mark.parametrize("case", list(CHECK_ERRORS))
def test_batch_argument_errors_word_for_word(case):
    _same_error(CHECK_ERRORS[case])


def test_batch_arguments_staged():
    seeds, (p,) = tb._check_param_batch_args(
        [3, 2**32 - 1], (tm.pack_param_batch(_dists(tm, "normal")),), 2, 1,
        (NORMAL,), "cpu")
    assert seeds.dtype == torch.int32
    assert (seeds.numpy().view(np.uint32) == [3, 2**32 - 1]).all()
    assert p.dtype == torch.float32 and p.shape == (2, 2)
    # A tensor already on the device is used as it is; an int64 one is cut
    # to its low 32 bits there.
    t = torch.tensor([5, 6], dtype=torch.int32)
    assert tb.stage_seeds(t, 2, "cpu") is t
    wide = tb.stage_seeds(torch.tensor([7, 2**32 - 2], dtype=torch.int64), 2, "cpu")
    assert (wide.numpy().view(np.uint32) == [7, 2**32 - 2]).all()
    with pytest.raises(ValueError, match="expected 2 seeds, got shape"):
        tb.stage_seeds(torch.tensor([1, 2, 3]), 2, "cpu")
    with pytest.raises(OverflowError):
        tb.stage_seeds([2**32], 1, "cpu")


def _nd(pkg):
    return pkg.pack_param_batch_nd(
        [[_n(pkg, 0, 1), _u(pkg, 0, 1)], [_n(pkg, 1, 2), _u(pkg, -1, 1)]])


def _nd_args(pkg, b, seeds, params, kinds=(NORMAL, UNIFORM)):
    if b is jb:
        run = lambda *a: "ran"  # noqa: E731
        return b._nd_param_prog(run, (None, None, None), 2, 2, kinds)(
            seeds, params)
    return b._check_nd_params(seeds, params, 2, 2, kinds)


ND_ERRORS = {
    "seed-count": lambda pkg, b: _nd_args(pkg, b, [1], _nd(pkg)),
    "families": lambda pkg, b: _nd_args(pkg, b, [1, 2], _nd(pkg),
                                        kinds=(UNIFORM, NORMAL)),
    "shape": lambda pkg, b: _nd_args(pkg, b, [1, 2],
                                     np.zeros((2, 3, 2), np.float32)),
}


@pytest.mark.parametrize("case", list(ND_ERRORS))
def test_nd_argument_errors_word_for_word(case):
    _same_error(ND_ERRORS[case])


def _nd_mcmc_args(pkg, b, targ, prop, rw=False, adapt=False):
    kinds = (NORMAL, UNIFORM)
    if b is jb:
        run = lambda *a: "ran"  # noqa: E731
        return b._nd_mcmc_param_prog(run, 2, 2, kinds, kinds, rw, adapt)(
            [1, 2], targ, prop)
    return b._check_nd_mcmc_params([1, 2], targ, prop, 2, 2, kinds, kinds,
                                   rw, adapt)


def _rw_nd(pkg, adapt=False):
    return pkg.pack_random_walk_batch_nd(
        [pkg.RandomWalk(adapt=adapt)] * 2, [_n(pkg, 0, 1), _u(pkg, 0, 1)])


ND_MCMC_ERRORS = {
    "target-families": lambda pkg, b: _nd_mcmc_args(
        pkg, b, pkg.pack_param_batch_nd([[_u(pkg, 0, 1), _n(pkg, 0, 1)]] * 2),
        _nd(pkg)),
    "proposal-shape": lambda pkg, b: _nd_mcmc_args(
        pkg, b, _nd(pkg), np.zeros((2, 2, 3), np.float32)),
    "walk-tag": lambda pkg, b: _nd_mcmc_args(pkg, b, _nd(pkg), _rw_nd(pkg),
                                             rw=True, adapt=True),
    "walk-shape": lambda pkg, b: _nd_mcmc_args(
        pkg, b, _nd(pkg), np.zeros((2, 2, 2), np.float32), rw=True),
}


@pytest.mark.parametrize("case", list(ND_MCMC_ERRORS))
def test_nd_mcmc_argument_errors_word_for_word(case):
    _same_error(ND_MCMC_ERRORS[case])


def test_nd_checks_stage_the_kernel_order():
    seeds, p = tb._check_nd_params([1, 2], _nd(tm), 2, 2, (NORMAL, UNIFORM))
    np.testing.assert_array_equal(p.numpy(), np.asarray(_nd(jmc)))
    seeds, prop, targ = tb._check_nd_mcmc_params(
        [1, 2], _nd(tm), _rw_nd(tm), 2, 2, (NORMAL, UNIFORM),
        (NORMAL, UNIFORM), True, False)
    np.testing.assert_array_equal(prop.numpy(), np.asarray(_rw_nd(jmc)))
    np.testing.assert_array_equal(targ.numpy(), np.asarray(_nd(jmc)))


def test_kind_names_word_for_word():
    for kind in ("rw", "rw_adapt", NORMAL, 9):
        assert tb._param_kind_name(kind) == jb._param_kind_name(kind)
