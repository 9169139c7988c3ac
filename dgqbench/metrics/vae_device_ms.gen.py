"""Device time of one VAE decode (a batch), the union of its device intervals."""


def read(rc):
    s = next((s for s in rc.sessions if s.label == "vae"), None)
    if s is None or not s.device_ops:
        return None
    return 1e3 * s.busy_s()
