"""Share of the traced Adam steps in which the device runs nothing: 1 - busy
(traced) / wall of the same steps run untraced in the same process, in
percent."""


def read(rc):
    s = next((s for s in rc.sessions if s.label == "steps"), None)
    if s is None or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.wall_untraced_s)
