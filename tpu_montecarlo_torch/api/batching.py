"""Seed and param batches (port of ``tpu_montecarlo/api/batching.py``):
the ``pack_*`` functions users feed param-batched handles, and the checks
and staging of a handle's ``(seeds, params...)`` arguments.

A batch of R jobs rides the batch axis of the kernel it runs in (the 1-D
and nd integrate kernels, the 1-D, nd and tempered MCMC kernels): one
launch, and element r equal bit for bit to the unbatched call with
``seeds[r]`` (and row r).
The port has no XLA route, so the JAX package's ``lax.map`` adapters have
no counterpart here."""

from __future__ import annotations

import numpy as np
import torch

from ..distributions import Distribution, RandomWalk
from ..sampling import DistKind, dist_spec_of, ensure_param_batch_family

__all__ = [
    "NdParamBatch",
    "ParamBatch",
    "RwParamBatch",
    "pack_param_batch",
    "pack_param_batch_nd",
    "pack_random_walk_batch",
    "pack_random_walk_batch_nd",
]


def stage(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: through
    pinned memory and an asynchronous copy on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _on(t, device) -> bool:
    """Whether ``t`` is a tensor on ``device`` (``"cuda"`` without an
    index takes any CUDA tensor)."""
    dev = torch.device(device)
    return (isinstance(t, torch.Tensor) and t.device.type == dev.type
            and dev.index in (None, t.device.index))


def stage_seeds(seeds, r: int, device) -> torch.Tensor:
    """(R,) seeds as int32 words (the uint32 bits) on ``device``.  A
    tensor already on the device is used as it is (an int64 one is cut to
    its low 32 bits there, with no range check, so nothing waits for the
    device); anything else goes through ``np.uint32``, which rejects
    seeds outside [0, 2**32) as the JAX package does."""
    if _on(seeds, device):
        if tuple(seeds.shape) != (r,):
            raise ValueError(
                f"expected {r} seeds, got shape {tuple(seeds.shape)}")
        if seeds.dtype == torch.int64:
            return (seeds & 0xFFFFFFFF).to(torch.int32)
        if seeds.dtype != torch.int32:
            raise ValueError(
                f"a seed tensor must be int32 or int64, got {seeds.dtype}")
        return seeds
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    seeds_arr = np.asarray(seeds, np.uint32)
    if seeds_arr.shape != (r,):
        raise ValueError(f"expected {r} seeds, got shape {seeds_arr.shape}")
    return stage(seeds_arr.view(np.int32), device)


def _float_rows(p, shape, device):
    """``(rows, its shape)``: a params argument as float32 on ``device``
    (a tensor on the device as it is, anything else through numpy), or
    None beside the shape it has when that is not ``shape``."""
    if _on(p, device):
        if tuple(p.shape) != shape:
            return None, tuple(p.shape)
        return p.to(torch.float32).contiguous(), shape
    if isinstance(p, torch.Tensor):
        p = p.cpu().numpy()
    arr = np.asarray(p, np.float32)
    if arr.shape != shape:
        return None, arr.shape
    return stage(arr, device), shape


def _check_param_batch_args(
    seeds, params, r: int, n_param_args: int = 1, param_kinds=(),
    device="cpu",
):
    """Check and stage the ``(seeds, params...)`` of a param-batched
    handle (``batching.py:98`` of the JAX package, its errors word for
    word): (R,) uint32 seeds and ``n_param_args`` (R, 2) float32 family
    rows (:func:`pack_param_batch`), or (R, 4) walk rows where
    ``param_kinds`` marks the slot ``"rw"`` / ``"rw_adapt"``
    (:func:`pack_random_walk_batch`).  A tagged pack for another family
    than the slot's is refused.  Returns the seeds (int32 words) and the
    params as tensors on ``device``."""
    seeds_t = stage_seeds(seeds, r, device)
    if len(params) != n_param_args:
        raise ValueError(
            f"expected {n_param_args} params array(s), got {len(params)}"
        )
    params_t = []
    for i, p in enumerate(params):
        kind = param_kinds[i] if i < len(param_kinds) else None
        width = 4 if kind in ("rw", "rw_adapt") else 2
        fam = getattr(p, "family", None)
        if fam is not None and kind is not None and fam != kind:
            raise ValueError(
                f"params array {i} was packed for "
                f"{_param_kind_name(fam)} but this program "
                f"was compiled for {_param_kind_name(kind)}"
            )
        p_t, shape = _float_rows(p, (r, width), device)
        if p_t is None:
            raise ValueError(
                f"expected a ({r}, {width}) params array, got shape {shape}"
            )
        params_t.append(p_t)
    return seeds_t, tuple(params_t)


def _checked_batch_prog(dispatch, seed_batch, n_param_args, param_kinds,
                        device):
    """The ``prog(seeds, *params)`` handle of every param-batched
    program: check and stage the arguments, then hand ``(seeds,
    params)`` to the path's ``dispatch``."""

    def prog(seeds, *params):
        seeds_t, params_t = _check_param_batch_args(
            seeds, params, seed_batch, n_param_args, param_kinds, device
        )
        return dispatch(seeds_t, params_t)

    return prog


def _check_random_walk_args(
    rw: RandomWalk, n_burnin: int, stateful: bool
) -> None:
    """``tpu_montecarlo/api/batching.py:55``: adaptation happens during
    burn-in, so it needs one, and its per-chain steps are not checkpointed,
    so adaptive runs are stateless."""
    name = type(rw).__name__
    if rw.adapt and n_burnin <= 0:
        raise ValueError(
            f"{name}(adapt=True) tunes the step during burn-in; "
            "pass n_burnin > 0 (or a fixed step_size with adapt=False)"
        )
    if rw.adapt and stateful:
        raise ValueError(
            f"{name}(adapt=True) is stateless-only: the adapted "
            "per-chain steps are not part of the checkpoint state.  "
            "Resume with a fixed step_size (adapt=False) instead"
        )


def _param_kind_name(kind) -> str:
    """Human name of a param-batch slot kind: a DistKind family or the
    ``"rw"`` / ``"rw_adapt"`` RandomWalk sentinels."""
    if kind == "rw":
        return "fixed-step RandomWalk proposals"
    if kind == "rw_adapt":
        return "adaptive RandomWalk proposals"
    return f"{DistKind(kind).name} distributions"


def _check_nd_params(seeds, params, seed_batch: int, d: int, kinds,
                     device="cpu"):
    """The nd param-batched handle's checks (``_nd_param_prog``,
    ``batching.py:172`` of the JAX package): (R,) seeds and an (R, d, 2)
    array of per-dimension family rows (:func:`pack_param_batch_nd`),
    whose tagged families must be the program's.  Returns both staged on
    ``device``."""
    seeds_t = stage_seeds(seeds, seed_batch, device)
    fams = getattr(params, "families", None)
    if fams is not None and tuple(fams) != tuple(kinds):
        raise ValueError(
            "params were packed for dimensions "
            f"{tuple(DistKind(f).name for f in fams)} but this "
            "program was compiled for "
            f"{tuple(DistKind(k).name for k in kinds)}"
        )
    p_t, shape = _float_rows(params, (seed_batch, d, 2), device)
    if p_t is None:
        raise ValueError(
            f"expected a ({seed_batch}, {d}, 2) params array "
            f"(pack_param_batch_nd), got shape {shape}"
        )
    return seeds_t, p_t


def _check_nd_mcmc_params(seeds, target_params, proposal_params,
                          seed_batch: int, d: int, targ_kinds, prop_kinds,
                          random_walk: bool = False, rw_adapt: bool = False,
                          device="cpu"):
    """The nd MCMC param-batched handle's checks
    (``_nd_mcmc_param_prog``, ``batching.py:230`` of the JAX package):
    (R,) seeds, an (R, d, 2) target array and an (R, d, 2) proposal one,
    or (R, d, 4) walk rows (:func:`pack_random_walk_batch_nd`) under a
    RandomWalk proposal.  Returns (seeds, proposal, target) staged on
    ``device``, in the kernel's order."""

    def _check(params, kinds, role, width=2):
        fams = getattr(params, "families", None)
        if fams is not None and tuple(fams) != tuple(kinds):
            raise ValueError(
                f"{role} params were packed for dimensions "
                f"{tuple(DistKind(f).name for f in fams)} but this "
                "program was compiled for "
                f"{tuple(DistKind(k).name for k in kinds)}"
            )
        p_t, shape = _float_rows(params, (seed_batch, d, width), device)
        if p_t is None:
            raise ValueError(
                f"expected a ({seed_batch}, {d}, {width}) {role} params "
                f"array, got shape {shape}"
            )
        return p_t

    def _check_rw(params):
        want = "rw_adapt" if rw_adapt else "rw"
        fam = getattr(params, "family", None)
        if fam is not None and fam != want:
            raise ValueError(
                "this program was compiled for "
                f"{_param_kind_name(want)}; pack matching (R, d, 4) "
                "rows with pack_random_walk_batch_nd, got a pack for "
                f"{_param_kind_name(fam)}"
            )
        p_t, shape = _float_rows(params, (seed_batch, d, 4), device)
        if p_t is None:
            raise ValueError(
                f"expected a ({seed_batch}, {d}, 4) RandomWalk params "
                f"array (pack_random_walk_batch_nd), got shape {shape}"
            )
        return p_t

    seeds_t = stage_seeds(seeds, seed_batch, device)
    targ = _check(target_params, targ_kinds, "target")
    prop = (_check_rw(proposal_params) if random_walk
            else _check(proposal_params, prop_kinds, "proposal"))
    return seeds_t, prop, targ


class NdParamBatch(np.ndarray):
    """(R, d, 2) float32 per-dimension family-parameter rows tagged
    with the per-dimension ``families`` tuple, so a mismatched nd
    param-batched handle rejects the pack at dispatch time."""

    def __new__(cls, arr, families):
        obj = np.asarray(arr, np.float32).view(cls)
        obj.families = tuple(DistKind(f) for f in families)
        return obj

    def __array_finalize__(self, obj):
        if obj is not None and not hasattr(self, "families"):
            self.families = getattr(obj, "families", None)


def pack_param_batch_nd(rows) -> NdParamBatch:
    """Stack per-REPLICATION lists of per-DIMENSION analytic
    distributions into the (R, d, 2) array an nd ``param_batch`` handle
    takes: ``rows[r][j]`` parameterizes dimension j of batch element r.
    Every replication must use the same family per dimension."""
    rows = [list(r) for r in rows]
    if not rows or not rows[0]:
        raise ValueError("param batch needs at least one replication row")
    d = len(rows[0])
    specs = []
    for r in rows:
        if len(r) != d:
            raise ValueError(
                "every replication must list the same number of "
                f"dimensions (got {len(r)} vs {d})"
            )
        specs.append([dist_spec_of(dd) for dd in r])
    families = tuple(s.kind for s in specs[0])
    for row in specs:
        for j, s in enumerate(row):
            if s.kind != families[j]:
                raise ValueError(
                    f"dimension {j} mixes families "
                    f"{families[j].name} and {s.kind.name}"
                )
            ensure_param_batch_family(s.kind)
    arr = np.stack(
        [np.stack([s.params for s in row]) for row in specs]
    )
    return NdParamBatch(arr, families)


class ParamBatch(np.ndarray):
    """(R, 2) float32 family-parameter rows tagged with the ``family``
    (DistKind) they parameterize, so a param-batched handle can reject a
    pack built for a different family at dispatch time."""

    def __new__(cls, arr, family):
        obj = np.asarray(arr, np.float32).view(cls)
        obj.family = DistKind(family)
        return obj

    def __array_finalize__(self, obj):
        if obj is not None and not hasattr(self, "family"):
            self.family = getattr(obj, "family", None)


def pack_param_batch(distributions) -> ParamBatch:
    """Stack the device parameter words of same-family analytic
    distributions into the (R, 2) float32 array a ``param_batch``
    program takes: uniform -> (min, max), normal -> (mean, std),
    exponential -> (lambda, 0), an extended family its two words — the
    packing of ``sampling.dist_spec_of``.  The result carries its family
    so a mismatched program rejects it at dispatch."""
    specs = [dist_spec_of(d) for d in distributions]
    if not specs:
        raise ValueError("param batch needs at least one distribution")
    kinds = {s.kind for s in specs}
    if len(kinds) != 1:
        raise ValueError(
            "param batch must share one family, got "
            f"{sorted(k.name for k in kinds)}"
        )
    ensure_param_batch_family(specs[0].kind)
    return ParamBatch(np.stack([s.params for s in specs]), specs[0].kind)


class RwParamBatch(np.ndarray):
    """(R, 4) (1-D) or (R, d, 4) (nd) float32 RandomWalk parameter rows
    — ``(step, init_lo, init_hi, target_accept)`` — tagged with the
    ``"rw"`` / ``"rw_adapt"`` sentinel family, so a handle compiled for
    density-backed proposals rejects the pack at dispatch time (and vice
    versa).  Step adaptation is a compiled-in kernel phase, not a row
    word, so adaptive and fixed-step packs carry distinct tags and a
    program compiled for one rejects the other."""

    def __new__(cls, arr, adapt: bool = False):
        obj = np.asarray(arr, np.float32).view(cls)
        obj.family = "rw_adapt" if adapt else "rw"
        return obj

    def __array_finalize__(self, obj):
        if obj is not None and not hasattr(self, "family"):
            self.family = getattr(obj, "family", "rw")


def _walks_targets_of(walks, target, what: str):
    """Validate a (walks, per-row targets) pairing for the RandomWalk
    pack functions.  ``target``: one shared value, a length-R sequence,
    or None (every walk then needs an explicit init_range)."""
    walks = list(walks)
    if not walks:
        raise ValueError("param batch needs at least one RandomWalk")
    for w in walks:
        if not isinstance(w, RandomWalk):
            raise TypeError(
                f"pack_random_walk_batch{what} takes RandomWalk "
                f"proposals, got {type(w)}"
            )
    if len({w.adapt for w in walks}) > 1:
        raise ValueError(
            "all walks in a param batch must share adapt= — step "
            "adaptation is a compile-time kernel phase (every row of "
            "an adaptive program adapts); run adaptive and fixed-step "
            "sweeps as separate programs"
        )
    if target is None or isinstance(target, Distribution):
        targets = [target] * len(walks)
    else:
        targets = list(target)
        if len(targets) != len(walks):
            raise ValueError(
                f"{len(walks)} walks but {len(targets)} targets; pass "
                "one shared target or one per replication row"
            )
    return walks, targets


def pack_random_walk_batch(walks, target=None) -> RwParamBatch:
    """Stack :class:`RandomWalk` proposals (HMC ones too) into the (R, 4)
    rows a 1-D ``param_batch`` MCMC handle takes in its proposal-params
    slot — one step-size/init-range/target-acceptance row per
    replication.  ``target``: the Distribution whose central 98%
    interval seeds default init ranges — one shared, a length-R list
    (matched to the swept target rows), or None when every walk carries
    an explicit ``init_range``."""
    walks, targets = _walks_targets_of(walks, target, "")
    rows = []
    for w, t in zip(walks, targets):
        rows.append(
            w.pack_params_nd([t] if t is not None else None, 1)[0]
        )
    return RwParamBatch(np.stack(rows), walks[0].adapt)


def pack_random_walk_batch_nd(walks, targets=None, d=None) -> RwParamBatch:
    """nd form of :func:`pack_random_walk_batch`: (R, d, 4) rows.
    ``targets``: the per-dimension Distribution list (shared across
    rows), a length-R list of such lists, or None for joint log-density
    targets (explicit ``init_range`` on every walk; ``d`` required
    then)."""
    shared = None
    if targets is not None:
        targets = list(targets)
        if targets and isinstance(targets[0], Distribution):
            shared = targets  # one per-dimension list for every row
            targets = None
    walks, per_row = _walks_targets_of(walks, targets, "_nd")
    if shared is not None:
        per_row = [shared] * len(walks)
    dims = {len(r) for r in per_row if r is not None}
    if len(dims) > 1:
        raise ValueError(
            f"rows mix dimension counts {sorted(dims)}"
        )
    if d is None:
        if not dims:
            raise ValueError(
                "pass d= when packing for a joint log-density target "
                "(no per-dimension target lists to read it from)"
            )
        d = dims.pop()
    elif dims and dims != {d}:
        raise ValueError(
            f"d={d} but the target lists have {dims.pop()} dimensions"
        )
    return RwParamBatch(
        np.stack([w.pack_params_nd(t, d) for w, t in zip(walks, per_row)]),
        walks[0].adapt,
    )
