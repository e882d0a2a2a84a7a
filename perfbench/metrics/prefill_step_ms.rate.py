"""``prefill_step_ms`` in a cell whose end-to-end metric it moves is
``prompt_tokens_per_s``: the base reader."""
from perfbench.harness.spec import reader

read = reader("prefill_step_ms").read
