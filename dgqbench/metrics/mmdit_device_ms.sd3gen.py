"""Device time of one SD3 transformer call: the union of the device
operations' intervals over the traced MMDiT calls, a call."""


def read(rc):
    s = next((s for s in rc.sessions if s.label == "mmdit"), None)
    if s is None or not s.device_ops:
        return None
    return 1e3 * s.busy_s() / s.units
