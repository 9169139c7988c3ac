"""Device operations (kernels, copies, fills) of one Adam step, from the trace."""


def read(rc):
    s = next((s for s in rc.sessions if s.label == "steps"), None)
    if s is None or not s.device_ops:
        return None
    return len(s.device_ops) / s.units
