#!/usr/bin/env python3
"""Reads c9b's warm call and its device idle share in a process of its own:
``integrate([x*y], [Beta(2,5), U(0,1)], n_samples=1e7)`` on one NVIDIA GPU,
through ``chip_smoke.idle_share`` (one ``torch.profiler`` window of warm
calls), three windows of 10 calls and one of 40.

    python3 tools/idle_probe.py

Prints the card's name and power limit, the warm call's host time (median
of 10) and each window's reading.  ``chip_smoke.py`` reads the same share
after forty other phases in one process; this reading is the call alone.
Exits 1 if a window traces no device time, 2 when no CUDA device is
available.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import tpu_montecarlo_torch as tm

    print(cs.card_line())
    dists = [tm.Distribution.beta(2.0, 5.0), tm.Distribution.uniform(0.0, 1.0)]

    def call():
        return tm.integrate(cs.C9B_FNS, dists, n_samples=cs.C9B_SAMPLES,
                            seed=cs.SEED)

    call()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t0)
    print(f"c9b warm call {float(np.median(walls)) * 1e3:.3f} ms median of "
          "10, host clock")
    shares = [cs.idle_share(call, n) for n in (10, 10, 10, 40)]
    return 1 if any(s is None for s in shares) else 0


if __name__ == "__main__":
    sys.exit(main())
