"""The flash_prefill kernels' bound time over their device time in the
traced window: the bound is counted from the window's prefill steps at
their real rows and prompt lengths (``harness/work.py``)."""
from perfbench.harness import work
from perfbench.harness.recorder import PREFILL_KINDS

KERNELS = ("flash_prefill",)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    seconds = run.trace.seconds(*KERNELS)
    if seconds <= 0:
        return None
    bound = work.Bound()
    for step, rows in run.traced_rows():
        if step.kind in PREFILL_KINDS:
            work.flash_prefill_bound(run.cfg, rows, run.peaks, bound)
    return 100.0 * bound.seconds / seconds
