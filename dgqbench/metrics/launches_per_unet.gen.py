"""Device operations (kernels, copies, fills) of one UNet call, from the trace."""


def read(rc):
    s = next((s for s in rc.sessions if s.label == "unet"), None)
    if s is None or not s.device_ops:
        return None
    return len(s.device_ops) / s.units
