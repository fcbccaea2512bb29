"""pines_roofline: the Pines gravity kernel's share of its roofline, %:
the least time of one call over the ensemble's lanes from the field's
shape (pbench/roofline.py, against the H100's published 700 W peaks) over
its device time a call (the trace's sum for `pines_kernel` over the
launches the program counted in the profiled ensemble)."""

from pbench import roofline

KERNEL = "pines_kernel"


def read(run):
    s = run.summary
    n = run.window.pines_launches
    if s is None or not n:
        return None
    t = sum(v for name, (v, _) in s["by_name"].items() if KERNEL in name)
    if t <= 0:
        return None
    f = run.cell.config["field"]
    bound, _ = roofline.pines_bound_s(int(run.cell.traffic["lanes"]), f["degree"], f["order"])
    return 100.0 * bound / (t / n)
