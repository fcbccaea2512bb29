"""eom_fused_pct: the share of the profiled ensemble's EOM evaluations that
ran fused, %: the device trace's `eom_post` launches (the fused EOM's last
kernel, one an evaluation) over the Pines launches the program counted in
that ensemble (one an evaluation, fused or not). 0 where the program has the
fused EOM and no evaluation took it; None where nothing was counted, or the
program has no fused EOM (`nyx_tpu_torch.dynamics.fused_eom`) at all."""

import importlib.util

KERNEL = "eom_post"


def read(run):
    s = run.summary
    n = run.window.pines_launches
    if s is None or not n or importlib.util.find_spec("nyx_tpu_torch.dynamics.fused_eom") is None:
        return None
    fused = sum(k for name, (_, k) in s["by_name"].items() if KERNEL in name)
    return 100.0 * fused / n
