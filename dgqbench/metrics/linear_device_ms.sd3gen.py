"""Device ms of the f32 linears in one SD3 transformer call: the program's
`dgq.linear` spans (`models.layers.linear`: the product and its bias, the
3xTF32 GEMM or the library's) in its timed MMDiT calls, their stream
extents less the device's idle inside them (`harness/spans.py`), summed,
over those calls. A program without the span reads nothing."""
from dgqbench.harness.spans import busy_ms_per


def read(rc):
    return busy_ms_per(rc.sessions, "dgq.linear", per="dgq.mmdit")
