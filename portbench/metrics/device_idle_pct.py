"""device_idle_pct: the share of the profiled ensemble's window (from its
start by the host's clock to the card's last operation) in which no
kernel, copy or set ran on the card, %."""


def read(run):
    s = run.summary
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
