"""Share of the traced UNet calls and decode in which the device runs
nothing: 1 - busy (traced) / wall of the same calls run untraced in the
same process, in percent."""


def read(rc):
    ss = [s for s in rc.sessions if s.label in ("unet", "vae") and s.device_ops]
    if not ss:
        return None
    return 100.0 * (1.0 - sum(s.busy_s() for s in ss) / sum(s.wall_untraced_s for s in ss))
