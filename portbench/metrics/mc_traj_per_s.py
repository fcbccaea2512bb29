"""mc_traj_per_s: lanes of the window that reached the arc's end with
finite states, over the window's seconds (from its start to the end of
its last ensemble), by the host's clock."""


def read(run):
    w = run.window
    return sum(e.n_ok for e in w.ensembles) / w.seconds
