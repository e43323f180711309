"""render_graph_share.edit: the geometric re-renders on the card that
replayed their shape key's CUDA graph, over all re-renders on the card,
in the traced run's profiler slice, in %, from the port's
`count.render_graph.replay` and `.eager` counters (a capture's render is
its eager run).  None where the port counts no such render."""

from perfbench.harness import spans


def read(t):
    r = spans.idle(t)
    if r is None:
        return None
    c = r["counts"]
    replays = c.get("count.render_graph.replay", 0)
    renders = replays + c.get("count.render_graph.eager", 0)
    return replays / renders * 100.0 if renders else None
