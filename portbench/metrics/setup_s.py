"""``setup_s``: from the process's start to the start of the window
(imports, the kernels' load or build, the warm call)."""


def read(run):
    return run.setup_s
