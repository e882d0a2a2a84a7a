"""Mean wall time of a prefill step call inside the window, from the
sync before it to the sync after it."""
from perfbench.harness.bench import step_ms
from perfbench.harness.recorder import PREFILL_KINDS


def read(run):
    return step_ms(run, PREFILL_KINDS)
