#!/usr/bin/env python3
"""Times every mix of the pipe probe (``tools/pipe_rates.cu``: IMAD, IMUL,
IADD3, LOP3, FFMA and FMNMX streams alone and in pairs) on one NVIDIA GPU
and holds each against the pipe model of ``chip_smoke.py``'s bounds.

    python3 tools/pipe_probe.py

Prints the card's name and power limit, then per mix each SASS opcode's
rate in the probe's loop (thread instructions per SM per clock, at the SM
clock read under load) and each pipe's share of its rate under the model.
Exits 1 if a mix runs above the model's ceiling by more than
``chip_smoke.PROBE_TOLERANCE``, 2 when no CUDA device is available.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    card = cs.card_line()
    print(card)
    cs.pipe_rates(cs.load_pipe_probe(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
