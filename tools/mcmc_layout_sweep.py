#!/usr/bin/env python3
"""Times the 1-D, nd and tempered MCMC kernels of ``tpu_montecarlo_torch``
on one NVIDIA GPU at their main paths' shape, per chain layout, with their
SASS bounds.

    python3 tools/mcmc_layout_sweep.py [--tree DIR] [--sweep]
        [--cells c5b,walk,c9e,c10b,c12,c12c] [--out FILE]
        [--outputs none,diag,draws,both] [--sass-dir DIR]

``--tree`` names the repository checkout whose package is timed (default:
this one); it may be an older checkout without chain layouts (or without
tempered layouts), which is then timed as it is.  The SASS counter and its
bounds are always this checkout's ``chip_smoke.py``.  Cells, all at 4096
chains x (1,000 burn-in + 10,000) steps with error bars
(``chip_smoke.py``'s MCMC_MAIN):

* ``c5b``: ``[x*x]``, independence N(0, 2) -> N(0, 1);
* ``walk``: ``[x*x]``, ``RandomWalk(adapt=True)`` -> N(0, 1);
* ``c11``: ``[x*x]``, ``HMC(step_size=0.9, n_leapfrog=8, adapt=True)``
  -> N(0, 1), at ``HMC_LAYOUT`` (a checkout that has 1-D HMC);
* ``c9e``: ``[x*y]``, independence N(0, 2)^2 -> the bivariate normal
  joint log density with rho = 0.8;
* ``c10b``: ``[x*y]``, ``RandomWalk(step_size=1, target_accept=0.234,
  init_range=(-4, 4))`` on the same target;
* ``c12``: ``[x, x*x]``, the tempered kernel's main path (an adaptive
  walk of step 0.5 on the mixture 0.5 N(-4, 1) + 0.5 N(4, 1), ladder
  [1, 2, 4, 8]);
* ``c12c``: the same with independence N(0, 6) proposals;
* ``t3``, ``t2``, ``t5``, ``t16`` (named in ``--cells`` only): the other
  tempered modes of ``chip_smoke.py`` phase 20 at this shape, without
  error bars: a walk on N(1, 2) over [1, 3, 9]; independence N(0.5, 1.5)
  x Exp(1) on U(-1, 2) x Exp(1.5) over [1, 2.5]; a walk on c9e's target
  over [1, 2, 4, 8, 16]; and an adaptive walk on c9e's target over 16
  rungs 1.5^t, with error bars (the CUDA tests' T = 16 case); ``t24``
  the same over 24 rungs 1.2^t (32 rung lanes);
* ``ptk8``, ``ptk16``, ``ptk32``, ``ptk64``, ``ptwide`` (named in
  ``--cells`` only): c12 with the ``wide`` set's first 8, 16, 32, 64 and
  126 integrands, at 4096 x (200 + 1,000) steps;
* ``k2``, ``k4``, ``k8``, ``k16``, ``k32`` (named in ``--cells`` only):
  the first k of ``chip_smoke.py``'s K=8 bench integrands, repeated,
  independence N(0, 2) -> N(0, 1);
* ``wide`` (named in ``--cells`` only): 127 integrands of sines, tanh,
  indicators and polynomials, independence N(0, 2) -> N(0, 1), at 4096 x
  (200 + 1,000) steps.

``--sass-dir`` writes each build's kernel function, one instruction a
line without addresses, to ``DIR/<tree>-<cell>-<outputs>.sass``.
``--outputs`` times each cell also with split-R-hat and ESS (``diag``),
1,000 thinned draws (``draws``) or both (default: ``none``, the only one
an older checkout takes).  Without ``--sweep`` each cell runs its default layout; with it, every
layout of lanes in {1, 2, 4, 8} and group in {1, 2, 4, 8} (walks: one
lane; ``k*`` and ``wide``: group 4); a tempered cell runs the ladder
layout and rungs on T' lanes with lanes per rung in {1, 2, 4} (at most
32 lanes a chain) and group in {1, 2, 4, 8}.  Each result is one JSON line: kernel milliseconds (CUDA
events, the mean of 10 launches after one), the card's name and power
limit, the SM clock under load, the pipe bound (whole card for an
independence proposal, the chains' or rung moves' warps for a walk) with
its busiest pipe, the issue time, the carried-chain latency bound,
digests of the kernel's rows and final states (equal digests mean the
same chains to the last bit), nvcc's register and spill report, and the
kernel function's SASS digest (equal digests mean the same machine code)
with, per sample loop, its instructions, basic blocks, the blocks that
hold a shuffle, and its branches, convergence barriers (BSSY, BSYNC,
WARPSYNC), shuffles and global stores.  The counts are the build's own: a tempered
build of rungs on lanes counts per rung lane, padding lanes included,
and its decisions and exchanges repeat on the lanes of a rung and of a
pair.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
MAIN = dict(n_steps=10_000, n_burnin=1_000)
CHAINS = 4096
SEED = 42
REPS = 10
DRAWS = 1000


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _c9e_target():
    rho9 = 0.8
    c9c = 1.0 / (2.0 * (1.0 - rho9 * rho9))
    return lambda x, y: -c9c * (x * x - 2.0 * rho9 * x * y + y * y)


def _logmix(x):
    return math.log(
        math.exp(-0.5 * (x + 4.0) ** 2) + math.exp(-0.5 * (x - 4.0) ** 2)
    )


def _family(c):
    return [
        lambda x: x + c,
        lambda x: np.sin(c * x) + np.tanh(x),
        lambda x: (x > c) & (x < c + 0.5),
        lambda x: x * x * c,
    ]


WIDE_FNS = [f for i in range(32) for f in _family(i / 32.0)][:127]


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


# The opcodes counted in the sample loops: branches, the convergence
# barriers ptxas sets around a branch the warp may take apart, shuffles
# and global stores.
LOOP_OPCODES = ("BRA", "BSSY", "BSYNC", "WARPSYNC", "SHFL", "STG")


def _function_text(cs, listing: str, function: str) -> str:
    """The kernel function's instructions, one a line, without their
    addresses."""
    funcs = [ins for name, ins in cs.parse_functions(listing).items()
             if function in name]
    return "\n".join(f"{i.guard} {i.opcode} {i.operands}"
                     for i in funcs[0]) + "\n"


def _loop_sass(cs, listing: str, function: str) -> dict:
    """The kernel function's SASS digest (its instructions, addresses
    left out) and, per sample loop (``chip_smoke.sample_loops``), its
    instructions, basic blocks (cut after each branch and at each branch
    target), the blocks that hold a shuffle, and LOOP_OPCODES' counts."""
    funcs = [ins for name, ins in cs.parse_functions(listing).items()
             if function in name]
    instrs = funcs[0]
    text = _function_text(cs, listing, function)
    loops = []
    for lp in cs.sample_loops(instrs):
        body = [i for i in instrs if lp.start <= i.addr <= lp.end]
        targets = {i.branch_target() for i in body}
        blocks, cur = [], []
        for i in body:
            if i.addr in targets and cur:
                blocks.append(cur)
                cur = []
            cur.append(i)
            if i.base in ("BRA", "JMP"):
                blocks.append(cur)
                cur = []
        if cur:
            blocks.append(cur)
        rec = {"instructions": len(body), "blocks": len(blocks),
               "shfl_blocks": sum(any(i.base == "SHFL" for i in b)
                                  for b in blocks)}
        rec.update({op: sum(i.base == op for i in body)
                    for op in LOOP_OPCODES})
        loops.append(rec)
    return {"sass": hashlib.sha256(text.encode()).hexdigest()[:16],
            "loops": loops}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cells", default="c5b,walk,c9e,c10b,c12")
    ap.add_argument("--out", default=None)
    ap.add_argument("--outputs", default="none")
    ap.add_argument("--sass-dir", default=None)
    args = ap.parse_args()
    # (with_diagnostics, draws) per --outputs name; () keeps the older
    # checkouts' call signatures.
    output_sets = {"none": (), "diag": (True, 0), "draws": (False, DRAWS),
                   "both": (True, DRAWS)}
    outputs = [(name, output_sets[name]) for name in args.outputs.split(",")]
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import tpu_montecarlo_torch as tm
    from tpu_montecarlo_torch.ops import mcmc_kernel as mk
    from tpu_montecarlo_torch.ops.mcmc_nd_kernel import (
        McmcNdProgram,
        mcmc_nd_cuda,
    )
    from tpu_montecarlo_torch.sampling import DistKind

    cs = _chip_smoke()
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    layouts = hasattr(mk, "Layout")
    grid = mk.plan_mcmc_grid(mk.plan_chains(CHAINS, None))
    integ = tm.MonteCarloIntegrator()
    n = DistKind.NORMAL
    n01 = tm.Distribution.normal(0.0, 1.0)
    n02 = tm.Distribution.normal(0.0, 2.0)
    n06 = tm.Distribution.normal(0.0, 6.0)

    # Each cell's build(layout) -> (run, library, kernel function, uniforms
    # per unit, rungs, lanes per unit, units per chain-step).
    def one_d(fns, mode, row, steps, outs=(), hmc=0):
        traced = tuple(tm.trace_function(f) for f in fns)
        cfg = mk.McmcConfig(mode, n, n, steps["n_steps"], steps["n_burnin"],
                            True, *(() if not outs else (False, *outs)),
                            **({"hmc_leapfrog": hmc} if hmc else {}))
        params = torch.tensor(row, dtype=torch.float32, device=dev)

        def build(layout):
            prog = (mk.McmcProgram(traced, layout=layout) if layouts
                    else mk.McmcProgram(traced))
            lib = prog.library(cfg) if layouts else prog.library()
            name = ("mcmc_kernel" if layouts
                    else f"mcmc_kernelILi{int(mode)}EE")
            lanes = 1 if layout is None else layout.lanes
            return (lambda: mk.mcmc_cuda(prog, cfg, params, SEED, grid),
                    lib, name, 2, 1, lanes, 1)

        return build

    def nd(fns, target, proposal, steps, outs=()):
        parsed = integ._parse_nd_mcmc_args(target, proposal)
        prog0, cfg, params = integ._nd_mcmc_kernel_program(
            fns, proposal, parsed, steps["n_steps"], steps["n_burnin"], True,
            *outs)

        def build(layout):
            prog = (McmcNdProgram(prog0.fns, cfg, prog0.target, layout=layout)
                    if layouts else prog0)
            lanes = 1 if layout is None else layout.lanes
            return (lambda: mcmc_nd_cuda(prog, cfg, params, SEED, grid),
                    prog.library(), "mcmc_nd_kernel", cfg.d + 1, 1, lanes, 1)

        return build

    def tempered(fns, target, proposal, temps, steps, stderr=True, outs=()):
        from tpu_montecarlo_torch.ops import mcmc_pt_kernel as pk

        parsed = integ._parse_nd_mcmc_args(target, proposal)
        prog0, cfg, params, ladder = integ._pt_kernel_program(
            fns, proposal, parsed, tuple(1.0 / t for t in temps),
            steps["n_steps"], steps["n_burnin"], stderr, *outs)
        t = cfg.n_temps

        def build(layout):
            prog = (pk.McmcPtProgram(prog0.fns, cfg, prog0.target,
                                     layout=layout)
                    if layout is not None else prog0)
            run = lambda: pk.mcmc_pt_cuda(prog, cfg, params, ladder, SEED,  # noqa: E731
                                          grid)
            if layout is None or layout.rung_lanes == 1:
                # The ladder: one thread's loop draws every rung's uniforms
                # and, on the cheapest path, the parity with fewer pairs'.
                return (run, prog.library(), "mcmc_pt_kernel",
                        t * (cfg.d + 1) + (t - 1) // 2, t, 1, 1)
            # Rungs on lanes: each lane draws its rung's d + 1 uniforms and
            # its pair's swap uniform; a chain-step is T' rung lanes.
            return (run, prog.library(), "mcmc_pt_kernel", cfg.d + 2, t,
                    layout.lanes, layout.rung_lanes)

        return build

    pt_k = {"ptk8": 8, "ptk16": 16, "ptk32": 32, "ptk64": 64, "ptwide": 126}

    def make_cells(outs):
        """The cells, each (build, mode, steps), with the outputs ``outs``
        (a (diagnostics, draws) pair, or () for none)."""
        walk_row = [*tm.RandomWalk(adapt=True).pack_params(n01), 0.0, 1.0]
        hmc_row = [*tm.HMC(step_size=0.9, n_leapfrog=8, adapt=True)
                   .pack_params(n01), 0.0, 1.0]
        c10b_kw = dict(step_size=1.0, target_accept=0.234, init_range=(-4.0, 4.0))
        c10b = tm.RandomWalk(**c10b_kw)
        c12_walk = tm.RandomWalk(step_size=0.5, adapt=True, init_range=(3.0, 5.0))
        pt_fns = [lambda x: x, lambda x: x * x]
        pt2_fns = [lambda x, y: x * y, lambda x, y: x * x + y * y,
                   lambda x, y: (x > 1.0) * y]
        ladder4 = [1.0, 2.0, 4.0, 8.0]
        cells = {
            "c5b": (one_d([lambda x: x * x], mk.Mode.INDEPENDENCE,
                          [0.0, 2.0, 0.0, 0.0, 0.0, 1.0], MAIN, outs=outs), 0, MAIN),
            "walk": (one_d([lambda x: x * x], mk.Mode.ADAPTIVE, walk_row, MAIN, outs=outs),
                     2, MAIN),
            "c11": (one_d([lambda x: x * x], mk.Mode.ADAPTIVE, hmc_row, MAIN,
                          outs=outs, hmc=8), 2, MAIN),
            "c9e": (nd([lambda x, y: x * y], _c9e_target(), [n02, n02], MAIN, outs=outs),
                    0, MAIN),
            "c10b": (nd([lambda x, y: x * y], _c9e_target(), c10b, MAIN, outs=outs), 1,
                     MAIN),
            "c12": (tempered(pt_fns, _logmix, c12_walk, ladder4, MAIN, outs=outs), 2, MAIN),
            "c12c": (tempered(pt_fns, _logmix, n06, ladder4, MAIN, outs=outs), 0, MAIN),
            "t3": (tempered(pt_fns, tm.Distribution.normal(1.0, 2.0),
                            tm.RandomWalk(step_size=1.0, init_range=(-3.0, 5.0)),
                            [1.0, 3.0, 9.0], MAIN, False, outs=outs), 1, MAIN),
            "t2": (tempered(pt2_fns, [tm.Distribution.uniform(-1.0, 2.0),
                                      tm.Distribution.exponential(1.5)],
                            [tm.Distribution.normal(0.5, 1.5),
                             tm.Distribution.exponential(1.0)],
                            [1.0, 2.5], MAIN, False, outs=outs), 0, MAIN),
            "t5": (tempered(pt2_fns, _c9e_target(), c10b,
                            [1.0, 2.0, 4.0, 8.0, 16.0], MAIN, False, outs=outs), 1, MAIN),
            "t16": (tempered(pt2_fns, _c9e_target(),
                             tm.RandomWalk(adapt=True, **c10b_kw),
                             [1.5 ** t for t in range(16)], MAIN, outs=outs), 2, MAIN),
        }
        cells["t24"] = (tempered(pt2_fns, _c9e_target(),
                                 tm.RandomWalk(adapt=True, **c10b_kw),
                                 [1.2 ** t for t in range(24)], MAIN, outs=outs), 2, MAIN)
        wide_steps = dict(n_steps=1_000, n_burnin=200)
        for name, k in pt_k.items():
            cells[name] = (tempered(WIDE_FNS[:k], _logmix, c12_walk, ladder4,
                                    wide_steps, outs=outs), 2, wide_steps)
        indep_row = [0.0, 2.0, 0.0, 0.0, 0.0, 1.0]
        for k in (2, 4, 8, 16, 32):
            fns = [cs.BENCH_FNS[i % len(cs.BENCH_FNS)] for i in range(k)]
            cells[f"k{k}"] = (one_d(fns, mk.Mode.INDEPENDENCE, indep_row, MAIN, outs=outs),
                              0, MAIN)
        cells["wide"] = (one_d(WIDE_FNS, mk.Mode.INDEPENDENCE, indep_row,
                               wide_steps, outs=outs), 0, wide_steps)
        return {name: cells[name] for name in args.cells.split(",")}

    try:
        from tpu_montecarlo_torch.ops import mcmc_pt_kernel as pk
    except ImportError:
        pk = None
    pt_layouts = pk is not None and hasattr(pk, "PtLayout")
    rungs_of = {"c12": 4, "c12c": 4, "t3": 3, "t2": 2, "t5": 5, "t16": 16,
                "t24": 24, **dict.fromkeys(pt_k, 4)}

    def layouts_of(name, mode):
        if name in rungs_of:
            if not pt_layouts:
                return [None]
            n_temps = rungs_of[name]
            if not args.sweep:
                k = pt_k.get(name, 3 if name in ("t2", "t5", "t16", "t24")
                             else 2)
                return [pk.default_pt_layout(mode, n_temps, k)]
            t_lanes = pk.rung_lanes(n_temps)
            return [pk.LADDER_LAYOUT] + [
                pk.PtLayout(t_lanes, lanes, g) for lanes in (1, 2, 4)
                for g in (1, 2, 4, 8) if t_lanes * lanes <= 32]
        if not layouts:
            return [None]
        if name == "c11":
            return [mk.HMC_LAYOUT]
        if not args.sweep:
            k = {"wide": 127}.get(name, int(name[1:]) if name[0] == "k"
                                  else 1)
            return [mk.default_layout(mode, k)]
        if name == "wide" or name[0] == "k":
            return [mk.Layout(lanes, 4) for lanes in (1, 2, 4, 8)]
        if mode != 0:
            return [mk.Layout(1, g) for g in (1, 2, 4, 8)]
        return [mk.Layout(lanes, g) for lanes in (1, 2, 4, 8)
                for g in (1, 2, 4, 8)]

    jobs = [(name, mode, steps, build, layout, out_name)
            for out_name, outs in outputs
            for name, (build, mode, steps) in make_cells(outs).items()
            for layout in layouts_of(name, mode)]
    # An older checkout builds one 1-D library for c5b and walk: one at a
    # time there.
    with ThreadPoolExecutor(max_workers=8 if layouts else 1) as pool:
        built = list(pool.map(lambda j: j[3](j[4]), jobs))

    out = open(args.out, "a") if args.out else None
    for (name, mode, steps, _, layout, out_name), (
            run, lib, function, uniforms, rungs, lanes, unit_lanes) in zip(
                jobs, built):
        got = run()
        torch.cuda.synchronize()
        ms = cs.time_ms(run, reps=REPS)
        mhz = cs.clock_under_load(run, ms)
        chain_steps = CHAINS * (steps["n_steps"] + steps["n_burnin"])
        steps_per_chain = steps["n_steps"] + steps["n_burnin"]
        listing = cs.sass_listing(lib)
        if args.sass_dir:
            sass_dir = Path(args.sass_dir)
            sass_dir.mkdir(parents=True, exist_ok=True)
            tree = Path(args.tree).resolve().name
            (sass_dir / f"{tree}-{name}-{out_name}.sass").write_text(
                _function_text(cs, listing, function))
        try:
            dear, cheap = cs.per_sample(listing, function, uniforms, lanes)
        except ValueError as err:
            # An older walk kernel converts its adaptive gain's float(i + 1)
            # unsigned, which the counter takes for a uniform.
            print(f"{name}: no bound: {err}", file=sys.stderr)
            dear = cheap = None
        bound = {}
        if dear is not None:
            w = (steps["n_steps"], steps["n_burnin"])
            counts = {k: (w[0] * dear[k] + w[1] * cheap[k]) / sum(w)
                      for k in dear}
            warps = cs.function_warps(mode, CHAINS, rungs)
            units = chain_steps * unit_lanes
            pipe_ms, pipe = cs.bound_ms(counts, units, sms, mhz, warps)
            bound = {
                "pipe_ms": pipe_ms,
                "pipe": pipe,
                "issue_ms": cs.issue_ms(counts, units, sms, mhz, warps),
                "carried": counts["carried"],
                "chain": counts["chain"],
                "latency_ms": cs.latency_ms(counts["carried"],
                                            steps_per_chain, mhz),
                # Per chain-step: a tempered build of rungs on lanes
                # counts per rung lane.
                "per_step": {k: counts[k] * unit_lanes
                             for k in ("fma", "fmaheavy", "alu", "xu", "issue")},
            }
        rec = {
            "tree": str(Path(args.tree).resolve().name),
            "cell": name,
            "outputs": out_name,
            "layout": None if layout is None else list(layout),
            "ms": ms,
            "card": card,
            "mhz": mhz,
            **bound,
            "rows": _digest(got.rows),
            "x_final": _digest(got.x_final),
            **_loop_sass(cs, listing, function),
            "ptxas": [ln.strip() for ln in lib.build_log.splitlines()
                      if "registers" in ln or "spill" in ln],
        }
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
