#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_montecarlo_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the fused integrate kernel from ``tpu_montecarlo_torch/csrc``
   and print the build seconds and nvcc's register report;
3. hold the kernel against its plain PyTorch version on the card, for the
   uniform, normal and exponential families at 2**24 samples: every mean
   within rel 1e-5 + abs 1e-6 (the two draw the same samples; the margin
   covers erfinv/libm last-bit differences and float32 summation order);
4. drive the main path, ``integrate(bench fns, Distribution.normal(0, 1),
   n_samples=1e9, seed=42)``, and check each of the 8 moments against its
   closed form within 6 sigma, and that the kernel's launch count rose;
5. at the main path's shape, 1e9 samples under N(0, 1): hold the kernel
   against the plain version with the same tolerance, time both (CUDA
   events) and time ``integrate()`` end to end (host clock).

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
        from tpu_montecarlo_torch.sampling import dist_spec_of
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

    # 2. Build: the program the main path will take from the cache.
    traced = tuple(tm.trace_function(f) for f in BENCH_FNS)
    program = GLOBAL_CACHE.get_or_build(
        ("integrate", fns_key(traced)), lambda: IntegrateProgram(traced)
    )
    t0 = time.perf_counter()
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

    print(json.dumps({"kernels": [{
        "name": "integrate",
        "route": "cuda",
        "source": "tpu_montecarlo_torch/csrc/integrate.cu",
        "replaces": "tpu_montecarlo/ops/integrate_pallas.py:969",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
