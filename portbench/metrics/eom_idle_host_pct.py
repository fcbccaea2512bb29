"""eom_idle_host_pct: the card's idle time inside the profiled ensemble's `mc.run` span
while an EOM span (`eom.call`, `eom.gravity`, `eom.srp`, `eom.drag`, ...)
was the host's innermost, over `mc.run`'s duration, %: the card waiting
on the host's launches of the force models (pbench/spans.py)."""

from pbench import spans


def read(run):
    return spans.layer_pct(run, "eom")
