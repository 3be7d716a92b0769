"""A program cache of its own for each test that counts the port's cache
entries.  The process-wide cache is a bounded LRU; under pytest-xdist one
worker runs many files in turn, and once earlier files have filled it, a
new entry evicts an old one and the count stays where it was.  A test
that takes ``program_cache`` counts only its own insertions."""

import pytest

from tpu_montecarlo_torch.api import integrator
from tpu_montecarlo_torch.api.cache import ProgramCache


@pytest.fixture
def program_cache(monkeypatch):
    """An empty :class:`ProgramCache` that every integrator made during
    the test takes in place of the process-wide one."""
    cache = ProgramCache()
    monkeypatch.setattr(integrator, "GLOBAL_CACHE", cache)
    return cache
