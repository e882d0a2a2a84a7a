"""The SGMV kernels' (shrink and expand, counted as one pair) bound time
over their device time in the traced window: the bound is counted from
every step's real tokens and distinct adapters (``harness/work.py``)."""
from perfbench.harness import work

KERNELS = ("sgmv_shrink", "sgmv_expand")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    seconds = run.trace.seconds(*KERNELS)
    if seconds <= 0:
        return None
    bound = work.Bound()
    for _, rows in run.traced_rows():
        if rows:
            work.sgmv_bound(run.cfg, rows, run.peaks, bound)
    return 100.0 * bound.seconds / seconds
