"""cache_hit_share.edit: hits over lookups of the chain's three per-source
caches (label, encode, source) in the traced run's profiler slice, in %,
from the port's `count.cache.<name>.hit` and `.miss` counters."""

from perfbench.harness import spans

CACHES = ("label", "encode", "source")


def read(t):
    r = spans.idle(t)
    if r is None:
        return None
    c = r["counts"]
    hits = sum(c.get(f"count.cache.{n}.hit", 0) for n in CACHES)
    looked = hits + sum(c.get(f"count.cache.{n}.miss", 0) for n in CACHES)
    return hits / looked * 100.0 if looked else None
