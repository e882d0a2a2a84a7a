"""Useful model FLOPs of the traced window's real tokens (attention at
the real lengths; no bucket or power-of-two padding) over the window's
seconds times the device's bf16 peak (``peaks.json``)."""
from perfbench.harness import work


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    flops = sum(work.model_flops(run.cfg, rows)
                for _, rows in run.traced_rows())
    return 100.0 * flops / (run.trace.window_s
                            * run.peaks["bf16_flops_per_s"])
