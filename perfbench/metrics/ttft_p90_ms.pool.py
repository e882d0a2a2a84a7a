"""``ttft_p90_ms`` where the adapter pool parks admitted requests: a miss
waits in LOADING until the engine's virtual clock passes the modelled
copy, and a full pool defers selection, so the tail follows the
schedule's run-to-run timing and is read as a per-layer number: the base
reader."""
from perfbench.harness.spec import reader

read = reader("ttft_p90_ms").read
