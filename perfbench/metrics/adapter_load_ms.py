"""Device time of the host-to-device copies from the pinned adapter bank
into the pool, over the adapter loads of the traced window."""

PINNED_H2D = "Memcpy HtoD (Pinned"


def read(run):
    if run.trace is None:
        return None
    loads = sum(1 for t, _ in run.load_spans
                if run.start <= t <= run.stop)
    seconds = run.trace.seconds(PINNED_H2D)
    return 1e3 * seconds / loads if loads and seconds > 0 else None
