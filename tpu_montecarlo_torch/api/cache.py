"""In-process program cache (port of ``tpu_montecarlo/api/cache.py``).

Programs are keyed by the traced functions' content keys
(``tracing.function_fingerprint``), so a second call with fresh but
identical lambdas neither lowers nor compiles again."""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["GLOBAL_CACHE", "ProgramCache", "fns_key"]


class ProgramCache:
    """Bounded LRU of built programs."""

    def __init__(self, maxsize: int = 128):
        self._store: OrderedDict = OrderedDict()
        self._maxsize = maxsize

    def get_or_build(self, key, builder):
        if key in self._store:
            self._store.move_to_end(key)
            return self._store[key]
        value = builder()
        self._store[key] = value
        if len(self._store) > self._maxsize:
            self._store.popitem(last=False)
        return value


GLOBAL_CACHE = ProgramCache()


def fns_key(fns) -> tuple:
    return tuple(f.key for f in fns)
