"""integ_idle_host_pct: the card's idle time inside the profiled ensemble's `mc.run`
span while an integrator span (`integ.propagate`, `integ.check`,
`integ.step`) was the host's innermost, over `mc.run`'s duration, %: the
card waiting on the host loop's checks and step control
(pbench/spans.py)."""

from pbench import spans


def read(run):
    return spans.layer_pct(run, "integ")
