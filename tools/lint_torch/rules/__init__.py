"""The port's rules: one module per invariant, each the counterpart of
the reference rule with the same id in ``tools/lint/rules``."""

from __future__ import annotations

from tools.lint_torch.rules.el001_clock import PortClockPurityRule
from tools.lint_torch.rules.el002_tracer import PortTracerGuardRule
from tools.lint_torch.rules.el003_compile_registry import (
    CompileRegistryRule)
from tools.lint_torch.rules.el004_host_sync import PortHostSyncRule
from tools.lint_torch.rules.el005_rng import PortRngStreamRule
from tools.lint_torch.rules.el006_hooks import PortHookHygieneRule

ALL_RULES = (
    PortClockPurityRule,
    PortTracerGuardRule,
    CompileRegistryRule,
    PortHostSyncRule,
    PortRngStreamRule,
    PortHookHygieneRule,
)
