"""integ_iterations: the integrator's host-loop iterations of an ensemble
(`Results.iterations`: the slowest lane's attempted steps, rounded up to
the loop's check points), the median over the window's ensembles."""

import statistics


def read(run):
    return float(statistics.median(e.iterations for e in run.window.ensembles))
