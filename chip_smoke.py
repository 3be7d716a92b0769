#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_montecarlo_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the fused integrate kernel from ``tpu_montecarlo_torch/csrc``
   and print the build seconds and nvcc's register report (the MCMC
   kernel's two integrand sets build at the same time, in parallel);
3. hold the kernel against its plain PyTorch version on the card, for the
   uniform, normal and exponential families at 2**24 samples: every mean
   within rel 1e-5 + abs 1e-6 (the two draw the same samples; the margin
   covers erfinv/libm last-bit differences and float32 summation order);
4. drive the main path, ``integrate(bench fns, Distribution.normal(0, 1),
   n_samples=1e9, seed=42)``, and check each of the 8 moments against its
   closed form within 6 sigma, and that the kernel's launch count rose;
5. at the main path's shape, 1e9 samples under N(0, 1): hold the kernel
   against the plain version with the same tolerance, time both (CUDA
   events) and time ``integrate()`` end to end (host clock);
6. finish building the MCMC kernel (``csrc/mcmc.cu``) and print nvcc's
   register and spill report;
7. hold the MCMC kernel against its plain version on the card in every
   mode (independence under three family pairs, random walk, adaptive
   walk, error bars) at 4096 chains x (200 + 1000) steps: at most 1% of
   the chains split (end more than 1e-3 apart), acceptance within 1e-3,
   means within 0.2 standard errors + 1e-6, error bars within rel 1e-3;
8. drive the MCMC main path, ``integrate_mcmc([x*x], N(0, 1), N(0, 2),
   n_steps=10_000, n_chains=4096, n_burnin=1_000, seed=42,
   return_stderr=True)``: E[x^2] within 6 standard errors of 1, and the
   launch counts of the chain kernel and of its pilot kernel rose;
9. at the main path's shape and configuration (error bars on, so pilot
   kernel and chain kernel): hold the kernel against the plain version as
   in phase 7, time both (CUDA events) and time ``integrate_mcmc()`` end
   to end (host clock), in chain-steps/s counted as 4096 x (10_000 +
   1_000); the kernel without error bars is timed beside them.

Prints the kernel record as one JSON line before the last, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no CUDA device is available or the port is not importable.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np

# bench.py's K=8 set (BASELINE.md config 2).
BENCH_FNS = [
    lambda x: x,
    lambda x: x * x,
    lambda x: x * x * x,
    lambda x: x * x * x * x,
    lambda x: np.sin(x),
    lambda x: np.exp(-x * x),
    lambda x: x > 1.0,
    lambda x: abs(x),
]
# Closed forms under N(0, 1): E[f] and Var[f] for each bench integrand.
_P_GT1 = 0.5 * math.erfc(1.0 / math.sqrt(2.0))
BENCH_MEANS = [
    0.0, 1.0, 0.0, 3.0, 0.0, 1.0 / math.sqrt(3.0), _P_GT1,
    math.sqrt(2.0 / math.pi),
]
BENCH_VARS = [
    1.0, 2.0, 15.0, 96.0, (1.0 - math.exp(-2.0)) / 2.0,
    1.0 / math.sqrt(5.0) - 1.0 / 3.0, _P_GT1 * (1.0 - _P_GT1),
    1.0 - 2.0 / math.pi,
]
# The MCMC main path (BASELINE.md config 5 in its analytic form) and the
# integrand set its kernel is held against its plain version with.
MCMC_MAIN_FNS = [lambda x: x * x]
MCMC_CHECK_FNS = [
    lambda x: x,
    lambda x: x * x,
    lambda x: np.sin(x),
    lambda x: x > 1.0,
]
MCMC_MAIN = dict(n_steps=10_000, n_chains=4096, n_burnin=1_000, seed=42)
MCMC_CHECK = dict(n_chains=4096, n_steps=1_000, n_burnin=200)
# Kernel and plain version run the same chain means; their error bars
# differ by float32 summation order in the block SS, s2 - n_b*mean^2 of
# pilot-shifted chain means (1.5e-4 relative at the main shape on an H100);
# a wrong SS or centroid row moves them by 1.6% or more.
STDERR_RTOL = 1e-3
MAIN_SAMPLES = 1_000_000_000
CHECK_SAMPLES = 1 << 24
SEED = 42
RTOL, ATOL = 1e-5, 1e-6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        import tpu_montecarlo_torch as tm
        from tpu_montecarlo_torch.api.cache import GLOBAL_CACHE, fns_key
        from tpu_montecarlo_torch.ops.integrate_kernel import (
            IntegrateProgram,
            integrate_cuda,
            integrate_reference,
            plan_grid,
        )
        from tpu_montecarlo_torch.ops.mcmc_kernel import (
            McmcConfig,
            McmcProgram,
            Mode,
            mcmc_cuda,
            mcmc_finish,
            mcmc_reference,
            plan_chains,
            plan_mcmc_grid,
        )
        from tpu_montecarlo_torch.sampling import DistKind, dist_spec_of
        from tpu_montecarlo_torch.utils.dispatch import make_integrate_plan
    except ImportError as e:
        print(f"tpu_montecarlo_torch is not importable: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. The card.
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. Build: the programs the main paths will take from the cache.  The
    # MCMC kernel's two integrand sets build in parallel with this one.
    traced = tuple(tm.trace_function(f) for f in BENCH_FNS)
    program = GLOBAL_CACHE.get_or_build(
        ("integrate", fns_key(traced)), lambda: IntegrateProgram(traced)
    )
    mcmc_traced = tuple(tm.trace_function(f) for f in MCMC_MAIN_FNS)
    mcmc_program = GLOBAL_CACHE.get_or_build(
        ("mcmc", fns_key(mcmc_traced)), lambda: McmcProgram(mcmc_traced)
    )
    check_program = McmcProgram(
        tuple(tm.trace_function(f) for f in MCMC_CHECK_FNS)
    )
    def timed_build(prog):
        start = time.perf_counter()
        return prog.library(), time.perf_counter() - start

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=2)
    mcmc_builds = [
        pool.submit(timed_build, p) for p in (mcmc_program, check_program)
    ]
    lib = program.library()
    build_s = time.perf_counter() - t0
    print(f"phase 2: built the integrate kernel in {build_s:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. Kernel against the plain version, three families, 2**24 samples.
    grid = plan_grid(make_integrate_plan(CHECK_SAMPLES).actual_samples)
    families = [
        tm.Distribution.uniform(-1.0, 2.0),
        tm.Distribution.normal(0.5, 1.5),
        tm.Distribution.exponential(2.0),
    ]

    def kernel_vs_plain(dist, grid, phase: str) -> float:
        """Means of the kernel and of the plain version on the same
        samples; fails unless they agree.  Returns the max abs diff."""
        spec = dist_spec_of(dist)
        params = torch.tensor(spec.params, device=dev)
        n = grid.actual_samples
        got = integrate_cuda(program, spec.kind, params, SEED, grid)
        want = integrate_reference(
            program.torch_fns, spec.kind, params, SEED, grid
        )
        got = got.double().cpu().numpy() / n
        want = want.double().cpu().numpy() / n
        err = np.abs(got - want)
        name = f"{spec.kind.name.lower()} at {n} samples"
        print(f"phase {phase}: {name}: kernel {got}")
        print(f"         plain  {want}  max|diff| {err.max():.3e}")
        if not np.all(np.isfinite(got)):
            fail(f"{name}: non-finite kernel means {got}")
        if not np.all(err <= RTOL * np.abs(want) + ATOL):
            fail(f"{name}: kernel and plain version disagree")
        return float(err.max())

    max_abs_err = max(kernel_vs_plain(d, grid, "3") for d in families)

    # 4. The main path, through the public API, counted.
    integrate_cuda.launches = 0
    t0 = time.perf_counter()
    result = tm.integrate(
        BENCH_FNS, tm.Distribution.normal(0.0, 1.0),
        n_samples=MAIN_SAMPLES, seed=SEED,
    )
    main_s = time.perf_counter() - t0
    launches = integrate_cuda.launches
    main_grid = plan_grid(make_integrate_plan(MAIN_SAMPLES).actual_samples)
    n_main = main_grid.actual_samples
    print(f"phase 4: integrate(8 fns, N(0,1), n_samples={MAIN_SAMPLES}) "
          f"drew {n_main} samples in {main_s:.3f} s (host clock), "
          f"{launches} kernel launch(es)")
    if launches < 1:
        fail("the main path did not launch the integrate kernel")
    values = np.asarray(result.values)
    if values.shape != (len(BENCH_FNS),) or not np.all(np.isfinite(values)):
        fail(f"bad main-path result {values!r}")
    for j, (v, mu, var) in enumerate(zip(values, BENCH_MEANS, BENCH_VARS)):
        sigma = math.sqrt(var / n_main)
        z = (v - mu) / sigma
        print(f"  f{j}: {v:+.7f}  closed form {mu:+.7f}  z = {z:+.2f}")
        if abs(z) > 6.0:
            fail(f"f{j} is {z:.1f} sigma from its closed form")

    # 5. Kernel and plain version at the main path's shape: 1e9 samples.
    normal = tm.Distribution.normal(0.0, 1.0)
    max_abs_err = max(max_abs_err, kernel_vs_plain(normal, main_grid, "5"))
    spec = dist_spec_of(normal)
    params = torch.tensor(spec.params, device=dev)
    ms = time_ms(
        lambda: integrate_cuda(program, spec.kind, params, SEED, main_grid),
        reps=10,
    )
    plain_ms = time_ms(
        lambda: integrate_reference(
            program.torch_fns, spec.kind, params, SEED, main_grid
        ),
        reps=2,
    )
    # End to end, as a user calls it (tracing, planning, cached program,
    # launch, second-pass sum, copy of the means to the host).
    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        tm.integrate(BENCH_FNS, normal, n_samples=MAIN_SAMPLES, seed=SEED)
        call_s.append(time.perf_counter() - t0)
    call_ms = float(np.median(call_s)) * 1e3
    print(f"phase 5: {n_main} samples, K=8, N(0,1) on {card}: kernel "
          f"{ms:.3f} ms ({n_main / ms * 1e3:.4e} samples/s), plain "
          f"{plain_ms:.3f} ms ({n_main / plain_ms * 1e3:.4e} samples/s), "
          f"integrate() end to end {call_ms:.3f} ms median of 5, host clock "
          f"({n_main / call_ms * 1e3:.4e} samples/s)")

    # 6. The MCMC kernel's builds, started in phase 2.
    built = [b.result() for b in mcmc_builds]
    pool.shutdown()
    print("phase 6: built the MCMC kernel for [x*x] and for 4 functions in "
          + " and ".join(f"{sec:.1f}" for _, sec in built)
          + " s (in parallel with phase 2)")
    for mcmc_lib, _ in built:
        for line in mcmc_lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 7. MCMC kernel against the plain version in every mode.
    n, u, e = DistKind.NORMAL, DistKind.UNIFORM, DistKind.EXPONENTIAL
    walk = [0.8, -2.3, 2.3, 0.44]
    mcmc_cases = [
        ("independence N(0,2)->N(0,1)", Mode.INDEPENDENCE, n, n,
         [0.0, 2.0, 0, 0, 0.0, 1.0], False),
        ("independence U(0,6)->Exp(1.5)", Mode.INDEPENDENCE, u, e,
         [0.0, 6.0, 0, 0, 1.5, 0.0], False),
        ("independence Exp(1)->Exp(2)", Mode.INDEPENDENCE, e, e,
         [1.0, 0.0, 0, 0, 2.0, 0.0], False),
        ("random walk ->N(0,1)", Mode.RANDOM_WALK, n, n,
         walk + [0.0, 1.0], False),
        ("adaptive walk ->N(0,1)", Mode.ADAPTIVE, n, n,
         walk + [0.0, 1.0], False),
        ("independence N(0,2)->N(0,1), stderr", Mode.INDEPENDENCE, n, n,
         [0.0, 2.0, 0, 0, 0.0, 1.0], True),
        ("adaptive walk ->U(-1,2), stderr", Mode.ADAPTIVE, u, u,
         [0.5, -1.0, 2.0, 0.44, -1.0, 2.0], True),
    ]

    def mcmc_vs_plain(prog, cfg, row, grid, phase: str) -> float:
        """Runs the kernel and the plain version on the same chains and
        fails unless they agree (tolerances in the docstring).  Returns
        the max abs difference of the means."""
        params = torch.tensor(row, dtype=torch.float32, device=dev)
        got = mcmc_cuda(prog, cfg, params, SEED, grid)
        torch.cuda.synchronize()
        want = mcmc_reference(prog.torch_fns, cfg, params, SEED, grid)
        k = len(prog.fns)
        x_k, x_p = got.x_final, want.x_final
        split = float(
            ((x_k - x_p).abs() > 1e-3 * (1.0 + x_p.abs())).float().mean()
        )
        v_k, a_k, s_k = mcmc_finish(got, grid, cfg, k)
        v_p, a_p, s_p = mcmc_finish(want, grid, cfg, k)
        _, _, se = mcmc_finish(want, grid, replace(cfg, with_stderr=True), k)
        v_k, v_p, se = (t.double().cpu().numpy() for t in (v_k, v_p, se))
        err = np.abs(v_k - v_p)
        print(f"phase {phase}: kernel {v_k} acc {float(a_k):.6f}")
        print(f"         plain  {v_p} acc {float(a_p):.6f}  max|diff| "
              f"{err.max():.3e} ({(err / se).max():.3f} stderr), "
              f"split chains {split:.4%}")
        if not (np.all(np.isfinite(v_k)) and torch.isfinite(x_k).all()):
            fail(f"phase {phase}: non-finite kernel output")
        if split > 0.01:
            fail(f"phase {phase}: {split:.2%} of the chains split")
        if abs(float(a_k) - float(a_p)) > 1e-3:
            fail(f"phase {phase}: acceptance rates disagree")
        if not np.all(err < 0.2 * se + 1e-6):
            fail(f"phase {phase}: kernel and plain means disagree")
        if cfg.with_stderr:
            s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
            print(f"         stderr kernel {s_k} plain {s_p}")
            if not np.allclose(s_k, s_p, rtol=STDERR_RTOL, atol=0.0):
                fail(f"phase {phase}: error bars disagree")
        return float(err.max())

    check_grid = plan_mcmc_grid(plan_chains(MCMC_CHECK["n_chains"], None))
    mcmc_err = 0.0
    for name, mode, prop, targ, row, stderr in mcmc_cases:
        print(f"phase 7: {name}, {check_grid.chains_actual} chains x "
              f"({MCMC_CHECK['n_burnin']} + {MCMC_CHECK['n_steps']}) steps")
        cfg = McmcConfig(mode, prop, targ, MCMC_CHECK["n_steps"],
                         MCMC_CHECK["n_burnin"], stderr)
        mcmc_err = max(mcmc_err,
                       mcmc_vs_plain(check_program, cfg, row, check_grid, "7"))

    # 8. The MCMC main path, through the public API, counted.
    target, proposal = tm.Distribution.normal(0.0, 1.0), tm.Distribution.normal(0.0, 2.0)
    mcmc_cuda.launches = mcmc_cuda.pilot_launches = 0
    t0 = time.perf_counter()
    r = tm.integrate_mcmc(MCMC_MAIN_FNS, target, proposal,
                          return_stderr=True, **MCMC_MAIN)
    main_s = time.perf_counter() - t0
    mcmc_launches = mcmc_cuda.launches
    pilot_launches = mcmc_cuda.pilot_launches
    chain_steps = MCMC_MAIN["n_chains"] * (
        MCMC_MAIN["n_steps"] + MCMC_MAIN["n_burnin"]
    )
    print(f"phase 8: integrate_mcmc([x*x], N(0,1), N(0,2), {MCMC_MAIN}, "
          f"return_stderr=True) in {main_s:.3f} s (host clock), "
          f"{mcmc_launches} chain kernel and {pilot_launches} pilot kernel "
          f"launch(es)")
    if mcmc_launches < 1:
        fail("the MCMC main path did not launch the MCMC kernel")
    if pilot_launches < 1:
        fail("the MCMC main path did not launch the pilot kernel")
    v, se = np.asarray(r.values), np.asarray(r.stderr)
    if v.shape != (1,) or not (np.all(np.isfinite(v)) and np.all(se > 0)):
        fail(f"bad MCMC main-path result {v!r} +- {se!r}")
    z = (v[0] - 1.0) / se[0]
    print(f"  E[x^2] = {v[0]:.6f} +- {se[0]:.6f} (z = {z:+.2f}), "
          f"acceptance {r.acceptance_rate:.4f}, n_samples {r.n_samples}")
    if abs(z) > 6.0 or not 0.0 < r.acceptance_rate < 1.0:
        fail("the MCMC main path's E[x^2] is not within 6 stderr of 1")

    # 9. Kernel and plain version at the main path's shape and
    # configuration: with error bars, as phase 8 ran it.
    main_grid = plan_mcmc_grid(plan_chains(MCMC_MAIN["n_chains"], None))
    main_cfg = McmcConfig(Mode.INDEPENDENCE, n, n, MCMC_MAIN["n_steps"],
                          MCMC_MAIN["n_burnin"], with_stderr=True)
    main_row = [0.0, 2.0, 0.0, 0.0, 0.0, 1.0]
    mcmc_err = max(mcmc_err, mcmc_vs_plain(
        mcmc_program, main_cfg, main_row, main_grid, "9"))
    params = torch.tensor(main_row, dtype=torch.float32, device=dev)
    mcmc_ms = time_ms(
        lambda: mcmc_cuda(mcmc_program, main_cfg, params, SEED, main_grid),
        reps=10,
    )
    no_stderr_cfg = replace(main_cfg, with_stderr=False)
    mcmc_no_stderr_ms = time_ms(
        lambda: mcmc_cuda(mcmc_program, no_stderr_cfg, params, SEED,
                          main_grid),
        reps=10,
    )
    mcmc_plain_ms = time_ms(
        lambda: mcmc_reference(mcmc_program.torch_fns, main_cfg, params,
                               SEED, main_grid),
        reps=1,
    )
    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        tm.integrate_mcmc(MCMC_MAIN_FNS, target, proposal,
                          return_stderr=True, **MCMC_MAIN)
        call_s.append(time.perf_counter() - t0)
    mcmc_call_ms = float(np.median(call_s)) * 1e3
    print(f"phase 9: {main_grid.chains_actual} chains x "
          f"({MCMC_MAIN['n_burnin']} + {MCMC_MAIN['n_steps']}) steps, "
          f"[x*x], N(0,2)->N(0,1), stderr, on {card}: kernel "
          f"{mcmc_ms:.3f} ms ({chain_steps / mcmc_ms * 1e3:.4e} "
          f"chain-steps/s; without stderr {mcmc_no_stderr_ms:.3f} ms), "
          f"plain {mcmc_plain_ms:.3f} ms "
          f"({chain_steps / mcmc_plain_ms * 1e3:.4e} chain-steps/s), "
          f"integrate_mcmc() end to end {mcmc_call_ms:.3f} ms median of 5, "
          f"host clock ({chain_steps / mcmc_call_ms * 1e3:.4e} "
          f"chain-steps/s)")

    print(json.dumps({"kernels": [{
        "name": "integrate",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/integrate.cu",
        "replaces": "tpu_montecarlo/ops/integrate_pallas.py:969",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "mcmc",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/mcmc.cu",
        "replaces": "tpu_montecarlo/ops/mcmc_pallas.py:612",
        "launches": mcmc_launches,
        "pilot_launches": pilot_launches,
        "max_abs_err": mcmc_err,
        "ms": mcmc_ms,
        "plain_ms": mcmc_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
