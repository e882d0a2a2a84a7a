"""EL005 — RNG stream discipline, over the port.

The contract is the reference's (``tools/lint/rules/el005_rng.py``):
every numpy ``default_rng`` in the port's serving/ and core/ takes a
``[seed, salt]`` list with a salt distinct across the scope. The
``torch.Generator(...).manual_seed(...)`` streams the engine draws
weights and adapters from are the counterparts of the reference's
``jax.random`` keys, which the reference rule does not police either;
torch's *global* RNG is EL001's.
"""
from __future__ import annotations

from tools.lint.framework import in_scope
from tools.lint.rules.el005_rng import RngStreamRule

SCOPE = ("src/repro_torch/serving/", "src/repro_torch/core/")


class PortRngStreamRule(RngStreamRule):
    def applies(self, relpath: str) -> bool:
        return in_scope(relpath, SCOPE)
