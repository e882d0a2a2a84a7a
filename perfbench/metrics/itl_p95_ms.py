"""95th percentile of every gap between two consecutive tokens of one
request, over all requests, inside the window (a prefill step that runs
between a request's tokens counts in its gap)."""
from perfbench.harness.bench import itl_ms, percentile


def read(run):
    return percentile(itl_ms(run), 95)
