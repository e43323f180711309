"""semantic_passes.edit: the semantic passes the port ran (its
`count.semantic_pass` counter) per edit pair of the traced run's profiler
slice."""

from perfbench.harness import spans


def read(t):
    r = spans.idle(t)
    if r is None or not t.get("units_prof"):
        return None
    return r["counts"].get("count.semantic_pass", 0) / t["units_prof"]
