"""Wall seconds from the start of the process to the start of the window:
imports, the kernels' build or load, weights, the adapter bank, the
engine and its warm-up serves."""


def read(run):
    return run.setup_s
