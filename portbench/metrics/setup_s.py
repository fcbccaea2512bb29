"""setup_s: seconds from the process's start to the end of the warm-up
(imports, CUDA, the kernel's build or load, the scene, one full-width
ensemble over the warm-up arc), by the host's clock."""


def read(run):
    return run.setup_s
