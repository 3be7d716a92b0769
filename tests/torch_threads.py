"""Torch's intra-op threads under pytest-xdist: each worker takes its
share of the cores, at least one, when the port's test files import this
module.  Left alone, every worker's torch starts a pool as wide as the
machine, and on 8 cores six workers' pools oversubscribe them several
times over: the port's MCMC files, tens of small tensor ops per chain
step, then ran 3.5 times slower than with one thread each on an 8-core
host.  A run without workers keeps torch's default."""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
