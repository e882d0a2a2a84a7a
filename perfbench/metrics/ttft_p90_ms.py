"""90th percentile, over every request whose first token came inside the
window, of the wall time from its admission into a slot to that token.
The wait in the queue before admission is left out: in a backlog it is
set by the backlog's length."""
from perfbench.harness.bench import percentile, ttft_ms


def read(run):
    return percentile(ttft_ms(run), 90)
