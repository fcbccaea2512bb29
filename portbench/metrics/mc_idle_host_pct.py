"""mc_idle_host_pct: the card's idle time inside the profiled ensemble's `mc.run` span
while a Monte Carlo span (`mc.run` itself, `mc.draw`, `mc.context`,
`mc.gather`) was the host's innermost, over `mc.run`'s duration, %: how
long the card waits on the draw, the context and the gather
(pbench/spans.py)."""

from pbench import spans


def read(run):
    return spans.layer_pct(run, "mc")
