"""idle_share.edit: 1 - device busy / wall over the profiler slice, in %."""


def read(t):
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
