#!/usr/bin/env python3
"""Times the 1-D and nd MCMC kernels of ``tpu_montecarlo_torch`` on one
NVIDIA GPU at their main paths' shape, per chain layout, with their SASS
bounds.

    python3 tools/mcmc_layout_sweep.py [--tree DIR] [--sweep]
        [--cells c5b,walk,c9e,c10b,c12] [--out FILE]

``--tree`` names the repository checkout whose package is timed (default:
this one); it may be an older checkout without chain layouts, which is
then timed as it is.  The SASS counter and its bounds are always this
checkout's ``chip_smoke.py``.  Cells, all at 4096 chains x (1,000 burn-in
+ 10,000) steps with error bars (``chip_smoke.py``'s MCMC_MAIN):

* ``c5b``: ``[x*x]``, independence N(0, 2) -> N(0, 1);
* ``walk``: ``[x*x]``, ``RandomWalk(adapt=True)`` -> N(0, 1);
* ``c9e``: ``[x*y]``, independence N(0, 2)^2 -> the bivariate normal
  joint log density with rho = 0.8;
* ``c10b``: ``[x*y]``, ``RandomWalk(step_size=1, target_accept=0.234,
  init_range=(-4, 4))`` on the same target;
* ``c12``: ``[x, x*x]``, the tempered kernel's main path (an adaptive
  walk of step 0.5 on the mixture 0.5 N(-4, 1) + 0.5 N(4, 1), ladder
  [1, 2, 4, 8]), whose layout is fixed;
* ``k2``, ``k4``, ``k8``, ``k16``, ``k32`` (named in ``--cells`` only):
  the first k of ``chip_smoke.py``'s K=8 bench integrands, repeated,
  independence N(0, 2) -> N(0, 1);
* ``wide`` (named in ``--cells`` only): 127 integrands of sines, tanh,
  indicators and polynomials, independence N(0, 2) -> N(0, 1), at 4096 x
  (200 + 1,000) steps.

Without ``--sweep`` each cell runs its default layout; with it, every
layout of lanes in {1, 2, 4, 8} and group in {1, 2, 4, 8} (walks: one
lane; ``k*`` and ``wide``: group 4).  Each result is one JSON line: kernel milliseconds (CUDA events,
the mean of 10 launches after one), the card's name and power limit, the
SM clock under load, the pipe bound (whole card for an independence
proposal, the chains' or rung moves' warps for a walk) with its busiest
pipe, the issue time,
the carried-chain latency bound, and digests of the kernel's rows and
final states: equal digests mean the same chains to the last bit.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cells", default="c5b,walk,c9e,c10b,c12")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
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

    # Each cell's build(layout) -> (run, library, kernel function, uniforms
    # per chain-step, rungs).
    def one_d(fns, mode, row, steps):
        traced = tuple(tm.trace_function(f) for f in fns)
        cfg = mk.McmcConfig(mode, n, n, steps["n_steps"], steps["n_burnin"],
                            True)
        params = torch.tensor(row, dtype=torch.float32, device=dev)

        def build(layout):
            prog = (mk.McmcProgram(traced, layout=layout) if layouts
                    else mk.McmcProgram(traced))
            lib = prog.library(cfg) if layouts else prog.library()
            name = ("mcmc_kernel" if layouts
                    else f"mcmc_kernelILi{int(mode)}EE")
            return (lambda: mk.mcmc_cuda(prog, cfg, params, SEED, grid),
                    lib, name, 2, 1)

        return build

    def nd(fns, target, proposal, steps):
        parsed = integ._parse_nd_mcmc_args(target, proposal)
        prog0, cfg, params = integ._nd_mcmc_kernel_program(
            fns, proposal, parsed, steps["n_steps"], steps["n_burnin"], True)

        def build(layout):
            prog = (McmcNdProgram(prog0.fns, cfg, prog0.target, layout=layout)
                    if layouts else prog0)
            return (lambda: mcmc_nd_cuda(prog, cfg, params, SEED, grid),
                    prog.library(), "mcmc_nd_kernel", cfg.d + 1, 1)

        return build

    def tempered(fns, target, proposal, temps, steps):
        from tpu_montecarlo_torch.ops.mcmc_pt_kernel import mcmc_pt_cuda

        parsed = integ._parse_nd_mcmc_args(target, proposal)
        prog, cfg, params, ladder = integ._pt_kernel_program(
            fns, proposal, parsed, tuple(1.0 / t for t in temps),
            steps["n_steps"], steps["n_burnin"], True)
        t = cfg.n_temps

        def build(layout):
            return (lambda: mcmc_pt_cuda(prog, cfg, params, ladder, SEED,
                                         grid),
                    prog.library(), "mcmc_pt_kernel",
                    t * (cfg.d + 1) + (t - 1) // 2, t)

        return build

    walk_row = [*tm.RandomWalk(adapt=True).pack_params(n01), 0.0, 1.0]
    c10b = tm.RandomWalk(step_size=1.0, target_accept=0.234,
                         init_range=(-4.0, 4.0))
    cells = {
        "c5b": (one_d([lambda x: x * x], mk.Mode.INDEPENDENCE,
                      [0.0, 2.0, 0.0, 0.0, 0.0, 1.0], MAIN), 0, MAIN),
        "walk": (one_d([lambda x: x * x], mk.Mode.ADAPTIVE, walk_row, MAIN),
                 2, MAIN),
        "c9e": (nd([lambda x, y: x * y], _c9e_target(), [n02, n02], MAIN),
                0, MAIN),
        "c10b": (nd([lambda x, y: x * y], _c9e_target(), c10b, MAIN), 1,
                 MAIN),
        "c12": (tempered([lambda x: x, lambda x: x * x], _logmix,
                         tm.RandomWalk(step_size=0.5, adapt=True,
                                       init_range=(3.0, 5.0)),
                         [1.0, 2.0, 4.0, 8.0], MAIN), 2, MAIN),
    }
    indep_row = [0.0, 2.0, 0.0, 0.0, 0.0, 1.0]
    for k in (2, 4, 8, 16, 32):
        fns = [cs.BENCH_FNS[i % len(cs.BENCH_FNS)] for i in range(k)]
        cells[f"k{k}"] = (one_d(fns, mk.Mode.INDEPENDENCE, indep_row, MAIN),
                          0, MAIN)
    wide_steps = dict(n_steps=1_000, n_burnin=200)
    cells["wide"] = (one_d(WIDE_FNS, mk.Mode.INDEPENDENCE, indep_row,
                           wide_steps), 0, wide_steps)
    cells = {name: cells[name] for name in args.cells.split(",")}

    def layouts_of(name, mode):
        if not layouts or name == "c12":
            return [None]
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

    jobs = [(name, mode, steps, build, layout)
            for name, (build, mode, steps) in cells.items()
            for layout in layouts_of(name, mode)]
    # An older checkout builds one 1-D library for c5b and walk: one at a
    # time there.
    with ThreadPoolExecutor(max_workers=8 if layouts else 1) as pool:
        built = list(pool.map(lambda j: j[3](j[4]), jobs))

    out = open(args.out, "a") if args.out else None
    for (name, mode, steps, _, layout), (run, lib, function, uniforms,
                                         rungs) in zip(jobs, built):
        got = run()
        torch.cuda.synchronize()
        ms = cs.time_ms(run, reps=REPS)
        mhz = cs.clock_under_load(run, ms)
        chain_steps = CHAINS * (steps["n_steps"] + steps["n_burnin"])
        steps_per_chain = steps["n_steps"] + steps["n_burnin"]
        lanes = 1 if layout is None else layout.lanes
        try:
            dear, cheap = cs.per_sample(cs.sass_listing(lib), function,
                                        uniforms, lanes)
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
            pipe_ms, pipe = cs.bound_ms(counts, chain_steps, sms, mhz, warps)
            bound = {
                "pipe_ms": pipe_ms,
                "pipe": pipe,
                "issue_ms": cs.issue_ms(counts, chain_steps, sms, mhz, warps),
                "carried": counts["carried"],
                "chain": counts["chain"],
                "latency_ms": cs.latency_ms(counts["carried"],
                                            steps_per_chain, mhz),
                "per_step": {k: counts[k] for k in ("fp32", "int32", "xu",
                                                     "issue")},
            }
        rec = {
            "tree": str(Path(args.tree).resolve().name),
            "cell": name,
            "layout": None if layout is None else list(layout),
            "ms": ms,
            "card": card,
            "mhz": mhz,
            **bound,
            "rows": _digest(got.rows),
            "x_final": _digest(got.x_final),
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
