"""Device ms of one Adam step's update (the row feed's release, the
data-parallel all-reduce where there is one, `Adam.step`): the program's
`dgq.recon.optim` spans, their stream extents less the device's idle
inside them (`harness/spans.py`), over their count."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.recon.optim")
