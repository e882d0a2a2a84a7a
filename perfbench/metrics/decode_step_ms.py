"""Mean wall time of a decode step call inside the window, from the
sync before it to the sync after it."""
from perfbench.harness.bench import step_ms
from perfbench.harness.recorder import DECODE_KINDS


def read(run):
    return step_ms(run, DECODE_KINDS)
