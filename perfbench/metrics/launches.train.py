"""launches.train: device operations (kernels, copies, fills) per training
step in the traced run's profiler slice."""


def read(t):
    return len(t["device_events"]) / t["units_prof"] if t["units_prof"] \
        else None
