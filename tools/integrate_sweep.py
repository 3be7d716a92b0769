#!/usr/bin/env python3
"""Times the 1-D and nd integrate kernels of ``tpu_montecarlo_torch`` on
one NVIDIA GPU in every mode, per tuning, with their SASS counts.

    python3 tools/integrate_sweep.py [--tree DIR] [--cells u,n,e,...]
        [--unroll 1,2,4,8] [--blocks 8192,...] [--contract 1,0]
        [--define NAME=VALUE ...] [--sass DIR] [--out FILE]

A tuning is what the package fixes and this tool varies: the samples (nd:
positions) per loop body (``-DTMC_UNROLL``; default, the kernels'
``tmc::default_unroll``), the fused multiply-adds (``-DTMC_CONTRACT=0``
turns them off), the most CUDA blocks (the package's ``MAX_CUDA_BLOCKS``,
set in this process only), and any ``--define`` (for example
``TMC_WIDE_K=1``, which sends every integrand count to the 1-D kernel's
run-time position loop).  The defines go to ``nvcc`` through
``ops/build.py``'s ``load_kernel_library``.

``--tree`` names the repository checkout whose package is timed (default:
this one); a checkout whose ``load_kernel_library`` takes no defines is
timed as it is, once per cell.  The SASS counter is always this
checkout's ``chip_smoke.py``.  Cells (the means are printed so that two
trees can be compared):

* ``u``, ``n``, ``e``: 1-D, ``chip_smoke.py``'s K=8 bench set at 2^30
  samples under U(-1, 2), N(0, 1) (the main path) and Exp(2);
* ``k128``: 1-D, 128 integrands (sines, tanh, indicators, a branch)
  under N(0, 1) at 2^30; ``k<N>`` (named in ``--cells`` only): their
  first N;
* ``is`` (named in ``--cells`` only): ``chip_smoke.py``'s importance
  set at BASELINE.md config 4 ([x > 4] and the weight's unit integrand,
  weighted by N(0, 1) / N(4, 1.5), samples of N(4, 1.5)) at 2^30;
  ``is@mc_stderr`` is the one its main path runs;
* ``<1-D cell>@<mode>`` (named in ``--cells`` only): a 1-D cell in one of
  ``chip_smoke.py``'s ``MODES_1D`` (``antithetic``, ``qmc``,
  ``mc_stderr``, ``antithetic_stderr``), e.g. ``k17@mc_stderr``; this
  checkout's package only;
* ``c9``, ``c9s``, ``c9a``, ``c9as``: nd, c9's set (N(0,1) x U(0,1) x
  Exp(2), K = 2) at 2^30 samples in mc, mc with error bars, antithetic,
  antithetic with error bars;
* ``c9c``: one rotation of c9c's rQMC (``exp(x) * exp(y)`` over
  U(0,1)^2) at its per-rotation grid, 2^27 points;
* ``nd128``: nd, 128 two-argument integrands under N(0,1) x U(-1, 2),
  mc with error bars (256 sums per thread), at 2^30.

Each (cell, tuning) is one JSON line: kernel milliseconds (CUDA events,
the mean of 10 launches after one, wrapper and row sum included as in
``chip_smoke.py``), the card's name and power limit, the SM clock under
load, ``ptxas``' registers and spills, per sample (nd antithetic: per
pair of points) each pipe's instructions and the issue count on the
cheapest path through the sample loop (the dearest of several such
loops, as ``chip_smoke.py`` counts its bounds), the busiest pipe's bound
and the issue time, and the means.  With ``--sass DIR`` each cell's first
tuning also writes its kernel function's SASS to
``DIR/<tree>_<cell>.sass`` and is built as a cubin with line
information; that sample loop's cheapest path goes to
``DIR/<tree>_<cell>.txt`` with each instruction's source, and the record
gains ``breakdown``: the path's instructions per sample by what they do
(hash, convert, transform, integrands, accumulate, loop, branch;
``fused``, a ``tmc_fma`` whose caller the line information does not name:
an affine step of a transform or a sum).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import math
import re
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SEED = 42
REPS = 10
MAIN = 1 << 30


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _family(c):
    def branchy(x):
        if x > c:
            return math.exp(-abs(x)) * c
        return (x - c) ** 2

    return [
        lambda x: x + c,
        lambda x: np.sin(c * x) + np.tanh(x),
        lambda x: (x > c) & (x < c + 0.5),
        branchy,
    ]


def _nd_family(c):
    def branchy(x, y):
        if x > c:
            return math.exp(-abs(y)) * c
        return (x - c) ** 2 + y

    return [
        lambda x, y: x * y + c,
        lambda x, y: np.sin(c * x) + np.tanh(y),
        lambda x, y: (x > c) & (y < c + 0.5),
        branchy,
    ]


WIDE_FNS = [f for i in range(32) for f in _family(i / 32.0)]
ND_WIDE_FNS = [f for i in range(32) for f in _nd_family(i / 32.0)]

# Source functions by what they do, for --sass (a libdevice routine takes
# the line that calls it).
_ROLES = {
    "hash": {"pcg", "seed_state", "block_base", "mantissa", "cursor",
             "cursor_top24", "derive_shift", "derive_segment_shift",
             "sobol_xor", "sobol_mantissa", "sobol_top24"},
    "convert": {"halfopen01", "open01", "halfopen_top", "open_top"},
    "transform": {"next_below", "normal_from_u01", "transform",
                  "transform_pair", "normal_z", "transform_top",
                  "transform_pair_top", "family", "strata_x", "knot_interp"},
    "accumulate": {"tmc_accumulate", "tmc_accumulate_sq",
                   "tmc_accumulate_pair_sq", "tmc_accumulate_w",
                   "tmc_accumulate_sq_w", "tmc_accumulate_pair_sq_w",
                   "kernel_weight", "uniform_table_value",
                   "knot_table_value", "tmc_accumulate_nd",
                   "tmc_accumulate_nd_sq", "tmc_values_nd"},
    "loop": {"TileWalk", "stream", "next"},
}
_BRANCH = {"BRA", "BSSY", "BSYNC", "WARPSYNC", "BAR", "EXIT", "CALL", "RET",
           "NOP", "YIELD", "BREAK", "JMP"}
_DEF = re.compile(r"(?:__device__|__global__)[^(]*?\b(~?\w+)\s*\(")
_LOC = re.compile(r'//## File "([^"]+)", line (\d+)')


def _functions_by_line(path: Path) -> list:
    """Per line (1-based index) of a source file, the device function it
    lies in, or None."""
    out, current = [None], None
    for line in path.read_text().splitlines():
        m = _DEF.search(line)
        if m:
            current = m.group(1)
        elif line.startswith("}") or line.startswith("namespace"):
            current = None
        out.append(current)
    return out


def _role(frames, sources) -> str:
    """What the instruction at ``frames`` ([(file, line), ...], innermost
    first) does."""
    for file, line in frames:
        name = Path(file).name
        if name not in sources:
            sources[name] = (_functions_by_line(Path(file))
                             if Path(file).exists() else [])
        funcs = sources[name]
        fn = funcs[line] if line < len(funcs) else None
        if fn == "tmc_fma":
            # The caller says what the multiply-add is for, where the
            # line information names it.
            if len(frames) == 1:
                return "fused"
            continue
        if name == "tmc_integrands.inc":
            text = Path(file).read_text().splitlines()[line - 1]
            if fn in _ROLES["accumulate"] or "tmc_fma(" in text:
                return "accumulate"
            return "integrands"
        if name in ("integrand_math.cuh",):
            return "integrands"
        for role, names in _ROLES.items():
            if fn in names:
                return role
        text = Path(file).read_text().splitlines()[line - 1]
        if "acc[" in text or "sq[" in text:
            return "accumulate"
        return "loop"
    return "unattributed"


def breakdown(cs, cubin: Path, function: str, conversions: int,
              dump: Path) -> dict:
    """The sample loop's cheapest path in ``cubin`` per sample by role;
    writes the annotated path to ``dump``."""
    tools = Path("/usr/local/cuda/bin")
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    lined = subprocess.run([str(tools / "nvdisasm"), "--print-line-info",
                            str(cubin)],
                           capture_output=True, text=True, check=True).stdout
    (instrs,) = [v for k, v in cs.parse_functions(sass).items()
                 if function in k]
    loop = max(cs.sample_loops(instrs), key=lambda lp: lp.counts["issue"])
    # Line information per address of the function.
    where, current, frames = {}, None, []
    for line in lined.splitlines():
        m = re.search(r"\.text\.(\S+?)[:,\s]", line + " ")
        if m and "//" not in line.split(".text.")[0]:
            current = m.group(1)
            continue
        if "//## File" in line:
            frames = [(f, int(n)) for f, n in _LOC.findall(line)]
            continue
        m = cs._SASS_INSTR.search(line)
        if m and current and function in current:
            where[int(m.group(1), 16)] = frames
    path = set(loop.path)
    n = loop.counts["conversions"] / conversions
    roles, sources, lines = {}, {}, []
    for ins in instrs:
        if ins.addr not in path:
            continue
        frames = where.get(ins.addr, [])
        role = ("branch" if ins.base in _BRANCH else _role(frames, sources))
        roles[role] = roles.get(role, 0) + 1
        src = "; ".join(f"{Path(f).name}:{ln}" for f, ln in frames)
        lines.append(f"{ins.addr:05x} {role:12s} {ins.opcode} {ins.operands}"
                     f"   [{src}]")
    dump.write_text("\n".join(lines) + "\n")
    return {role: c / n for role, c in sorted(roles.items())}


def function_listing(listing: str, function: str) -> str:
    """The part of a ``cuobjdump -sass`` listing that holds the function
    whose name contains ``function``, without the instruction encodings
    (what ``chip_smoke.parse_functions`` reads)."""
    out, keep = [], False
    for line in listing.splitlines():
        if "Function :" in line:
            keep = function in line
        if keep:
            line = re.sub(r"\s*/\* 0x[0-9a-f]{16} \*/", "", line).rstrip()
            if line.strip():
                out.append(line)
    return "\n".join(out) + "\n"


def build_cubin(tree: Path, build, source: str, inc: str, defines,
                out: Path) -> Path:
    """``csrc/<source>`` of ``tree`` as a cubin with line information, as
    the tree's ``ops/build.py`` compiles it."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "tmc_integrands.inc").write_text(inc)
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = out / (Path(source).stem + ".cubin")
    csrc = tree / "tpu_montecarlo_torch" / "csrc"
    subprocess.run([build._nvcc(), *flags, "-cubin", "-lineinfo",
                    *(f"-D{d}" for d in defines), "-I", str(csrc),
                    "-I", str(out), str(csrc / source), "-o", str(cubin)],
                   check=True, capture_output=True, text=True)
    return cubin


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--cells", default="u,n,e,k128,c9,c9s,c9a,c9as,c9c,nd128")
    ap.add_argument("--unroll", default=None)
    ap.add_argument("--blocks", default=None)
    ap.add_argument("--contract", default=None)
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--sass", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import tpu_montecarlo_torch as tm
    from tpu_montecarlo_torch.ops import build
    from tpu_montecarlo_torch.ops import integrate_kernel as ik
    from tpu_montecarlo_torch.ops import integrate_nd_kernel as nk
    from tpu_montecarlo_torch.ops.lower import cuda_source
    from tpu_montecarlo_torch.sampling import dist_spec_of
    from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan

    cs = _chip_smoke()
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tuned = "defines" in inspect.signature(build.load_kernel_library).parameters
    if tuned:
        # Each job's defines reach the program's build through this
        # thread's value.
        local = threading.local()
        load = build.load_kernel_library

        def load_tuned(source, inc, defines=()):
            return load(source, inc, (*defines, *getattr(local, "defines", ())))

        build.load_kernel_library = load_tuned
    u01 = tm.Distribution.uniform(0.0, 1.0)
    n01 = tm.Distribution.normal(0.0, 1.0)
    c9_dists = [n01, u01, tm.Distribution.exponential(2.0)]
    one_d = {"u": (cs.BENCH_FNS, tm.Distribution.uniform(-1.0, 2.0)),
             "n": (cs.BENCH_FNS, n01),
             "e": (cs.BENCH_FNS, tm.Distribution.exponential(2.0)),
             "is": (cs.IS_FNS, tm.Distribution.normal(4.0, 1.5)),
             **{c: (WIDE_FNS[:int(c[1:])], n01)
                for c in (c.partition("@")[0] for c in args.cells.split(","))
                if re.fullmatch(r"k\d+", c)}}
    # name: (functions, dimensions, method, error bars, samples)
    nd = {"c9": (cs.ND_FNS, c9_dists, "mc", False, MAIN),
          "c9s": (cs.ND_FNS, c9_dists, "mc", True, MAIN),
          "c9a": (cs.ND_FNS, c9_dists, "antithetic", False, MAIN),
          "c9as": (cs.ND_FNS, c9_dists, "antithetic", True, MAIN),
          "c9c": (cs.QMC_FNS, [u01, u01], "qmc", False, MAIN // 8),
          "nd128": (ND_WIDE_FNS, [n01, tm.Distribution.uniform(-1.0, 2.0)],
                    "mc", True, MAIN)}

    def tunings():
        """Each tuning as (unroll, contract, blocks): None keeps the
        package's."""
        if not tuned:
            return [(None, None, None)]
        lists = [[None] if v is None else [int(x) for x in v.split(",")]
                 for v in (args.unroll, args.contract, args.blocks)]
        return [(u, c, b) for u in lists[0] for c in lists[1]
                for b in lists[2]]

    def defines(tuning):
        unroll, contract, _ = tuning
        return tuple(
            ([] if unroll is None else [f"TMC_UNROLL={unroll}"])
            + ([] if contract is None else [f"TMC_CONTRACT={contract}"])
            + list(args.define))

    def source_of(prog):
        """The integrand source a 1-D program's library compiles (a
        tree before importance sets has no ``weight``)."""
        weight = getattr(prog, "weight", None)
        if weight is None:
            return cuda_source(prog.fns)
        return cuda_source(prog.fns, weight=weight)

    # Each job builds (program, its library, function, conversions per
    # sample, samples counted, samples drawn, kernel source, integrand
    # source, run) for one tuning.
    def job_1d(name, tuning):
        base, _, mode = name.partition("@")
        fns, dist = one_d[base]
        traced = tuple(tm.trace_function(f) for f in fns)
        if base == "is":
            from tpu_montecarlo_torch.api.results import _unit_integrand

            weight = tuple(tm.trace_function(d._pdf_func) for d in (n01, dist))
            prog = ik.IntegrateProgram(traced + (_unit_integrand(),), weight)
        else:
            prog = ik.IntegrateProgram(traced)
        if tuned:
            local.defines = defines(tuning)
        spec = dist_spec_of(dist)
        params = torch.tensor(spec.params, device=dev)
        if not mode:
            prog.library()
            grid = ik.plan_grid(make_integrate_plan(MAIN).actual_samples)
            run = lambda: ik.integrate_cuda(prog, spec.kind, params,  # noqa: E731
                                            SEED, grid)
            return (prog, prog.library, f"integrate_kernelILi{int(spec.kind)}EE",
                    1, grid.actual_samples, grid.actual_samples,
                    "integrate.cu", source_of(prog), run)
        cfg = ik.IntegrateConfig(*cs.MODES_1D[mode])
        prog.library(cfg)
        grid = ik.plan_grid(make_integrate_plan(MAIN).actual_samples,
                            cfg.method)
        pilot = (ik.pilot_values(prog.torch_values, spec.kind, params)
                 if cfg.with_stderr else None)
        run = lambda: ik.integrate_cuda(prog, spec.kind, params, SEED,  # noqa: E731
                                        grid, cfg, pilot)
        units = grid.actual_samples // (2 if cfg.antithetic else 1)
        return (prog, lambda: prog.library(cfg),
                f"integrate_kernelILi{int(spec.kind)}EE", 1, units,
                grid.actual_samples, "integrate.cu",
                source_of(prog) + cfg.defines, run)

    def job_nd(name, tuning):
        fns, dists, method, stderr, n = nd[name]
        d = len(dists)
        specs = [dist_spec_of(x) for x in dists]
        kinds = tuple(sp.kind for sp in specs)
        prog = nk.IntegrateNdProgram(
            tuple(tm.trace_function(f, d) for f in fns), kinds)
        if tuned:
            local.defines = defines(tuning)
        prog.library()
        cfg = nk.NdConfig(kinds, method, stderr)
        grid = ik.plan_grid(make_integrate_plan(n).actual_samples, method)
        params = torch.tensor(np.stack([sp.params for sp in specs]),
                              device=dev)
        pilot = (nk.pilot_row(prog.torch_fns, kinds, params) if stderr
                 else None)
        run = lambda: nk.integrate_nd_cuda(prog, cfg, params, SEED, grid,  # noqa: E731
                                           pilot)
        code = {"mc": 0, "antithetic": 1, "qmc": 2}[method]
        units = grid.actual_samples // (2 if method == "antithetic" else 1)
        inc = (cuda_source(prog.fns) + "#define TMC_KINDS "
               + ", ".join(str(int(k)) for k in kinds) + "\n")
        return (prog, prog.library,
                f"integrate_nd_kernelILi{code}ELb{int(stderr)}EE",
                d, units, grid.actual_samples, "integrate_nd.cu", inc, run)

    cells = args.cells.split(",")
    jobs = [(c, t) for c in cells for t in tunings()]
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(
            lambda j: (job_nd if j[0] in nd else job_1d)(*j), jobs))

    out = open(args.out, "a") if args.out else None
    dumped = set()
    for (name, tuning), (prog, library, function, conv, units, drawn, source,
                         inc, run) in zip(jobs, built):
        blocks = ik.MAX_CUDA_BLOCKS
        if tuning[2] is not None:
            ik.MAX_CUDA_BLOCKS = nk.MAX_CUDA_BLOCKS = tuning[2]
        got = run()
        torch.cuda.synchronize()
        ms = cs.time_ms(run, reps=REPS)
        mhz = cs.clock_under_load(run, ms)
        ik.MAX_CUDA_BLOCKS = nk.MAX_CUDA_BLOCKS = blocks
        lib = library()
        listing = cs.sass_listing(lib)
        counts, _ = cs.per_sample(listing, function, conv)
        pipe_ms, pipe = cs.bound_ms(counts, units, sms, mhz)
        sums = got.double().cpu().numpy().reshape(-1)[:len(prog.fns)]
        rec = {
            "tree": tree.name,
            "cell": name,
            "tuning": None if not tuned else {
                "unroll": tuning[0], "contract": tuning[1],
                "blocks": tuning[2] or blocks, "defines": defines(tuning)},
            "ms": ms,
            "card": card,
            "mhz": mhz,
            "per_sample": counts,
            "bound_ms": pipe_ms,
            "pipe": pipe,
            "issue_ms": cs.issue_ms(counts, units, sms, mhz),
            "means": [float(v) for v in (sums / float(np.float32(drawn)))[:8]],
            "ptxas": [ln.strip() for ln in lib.build_log.splitlines()
                      if "registers" in ln or "spill" in ln],
        }
        if args.sass and name not in dumped:
            dumped.add(name)
            cubin = build_cubin(tree, build, source, inc,
                                defines(tuning) if tuned else (),
                                Path(args.sass) / f"{tree.name}_{name}")
            try:
                rec["breakdown"] = breakdown(
                    cs, cubin, function, conv,
                    Path(args.sass) / f"{tree.name}_{name}.txt")
            except (ValueError, OSError, subprocess.CalledProcessError) as err:
                rec["breakdown"] = f"not counted: {err!r}"
            (Path(args.sass) / f"{tree.name}_{name}.sass").write_text(
                function_listing(listing, function))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
