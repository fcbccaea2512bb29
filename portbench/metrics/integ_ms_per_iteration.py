"""integ_ms_per_iteration: host-clock milliseconds of the window's
unprofiled ensembles over their iterations (the profiled ensemble pays
the profiler's cost and is left out)."""


def read(run):
    es = [e for e in run.window.ensembles if not e.profiled]
    its = sum(e.iterations for e in es)
    return 1e3 * sum(e.wall_s for e in es) / its if its else None
