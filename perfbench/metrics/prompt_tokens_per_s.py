"""Real prompt tokens (no bucket padding) of every request whose prefill
finished inside the window, over the window's wall seconds (whole loop
iterations: from its start to the start of the last prefill step that
began inside the budget, ``bench.window_end``)."""


def read(run):
    firsts = run.rec.first_tokens(run.start, run.end)
    if not firsts:
        return None
    return sum(run.requests[rid].prompt_len for rid in firsts) / run.window_s
