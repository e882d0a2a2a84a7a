"""The adapter pool's hits over its lookups, counted between the
window's start and the last scheduler iteration that ended inside it."""


def read(run):
    first, last = run.rec.pool_in(run.start, run.end)
    hits, misses = last.hits - first.hits, last.misses - first.misses
    return 100.0 * hits / (hits + misses) if hits + misses else None
