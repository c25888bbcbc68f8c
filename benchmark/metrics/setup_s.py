"""Set-up: the process's start to the window's, with imports, the kernels'
build or load, the pool's generation and one warm solve per graph."""


def read(run):
    return run.setup_s
