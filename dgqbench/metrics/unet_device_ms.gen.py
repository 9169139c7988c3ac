"""Device time of one UNet call: the union of the device operations' intervals
over the traced UNet calls, a call."""


def read(rc):
    s = next((s for s in rc.sessions if s.label == "unet"), None)
    if s is None or not s.device_ops:
        return None
    return 1e3 * s.busy_s() / s.units
