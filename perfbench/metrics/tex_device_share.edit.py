"""tex_device_share.edit: the edit frames whose textural conditioning the
port built on the device, over all it assembled, in the traced run's
profiler slice, in %, from the port's `count.tex.assemble.device` and
`.host` counters.  None where the port counts no assembly (a port that
assembles on the host without counting)."""

from perfbench.harness import spans


def read(t):
    r = spans.idle(t)
    if r is None:
        return None
    c = r["counts"]
    device = c.get("count.tex.assemble.device", 0)
    frames = device + c.get("count.tex.assemble.host", 0)
    return device / frames * 100.0 if frames else None
