"""Engine invariant linter for the PyTorch port (``src/repro_torch/``).

The counterpart of ``tools/lint``: the same six contracts (virtual
clock, tracer guards, compile and cache registry, host syncs, RNG
streams, hook hygiene) held over the port's source, on the reference
linter's framework (``tools.lint.framework``), so both share one pragma
grammar and one tag set.

Entry point: ``python tools/lint_torch/engine_lint.py [paths...]``; rule
docs live in ``docs/static-analysis-torch.md``.
"""
