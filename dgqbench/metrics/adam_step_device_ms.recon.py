"""Device time of one Adam step of the reconstruction (forward, backward,
soft rounding, regulariser, update), over the traced steps."""


def read(rc):
    s = next((s for s in rc.sessions if s.label == "steps"), None)
    if s is None or not s.device_ops:
        return None
    return 1e3 * s.busy_s() / s.units
