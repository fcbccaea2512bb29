"""eom_kernels_per_iteration: CUDA kernels (copies and sets left out) in
the profiled ensemble's device trace, over its iterations: the launches an
integrator iteration costs, its 16 RK89 stages' EOM evaluations with the
step's own arithmetic."""


def read(run):
    s = run.summary
    prof = [e for e in run.window.ensembles if e.profiled]
    if s is None or not prof or not prof[0].iterations:
        return None
    kernels = sum(n for name, (_, n) in s["by_name"].items()
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels / prof[0].iterations
