"""Share of the window's wall time outside the engine's step calls
(scheduling, admission, pool bookkeeping, adapter copies, token
read-back), from the harness's stamps around each step."""


def read(run):
    inside = sum(b - a for _, a, b in run.clipped_steps())
    return 100.0 * (1.0 - inside / run.window_s)
