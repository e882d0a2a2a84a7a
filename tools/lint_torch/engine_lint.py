"""Engine invariant linter for the PyTorch port (stdlib only).

Runs the port's EL00x rules (tools/lint_torch/rules/) over
``src/repro_torch`` and reports ``path:line:col: RULE message`` findings:

    python tools/lint_torch/engine_lint.py           # src/repro_torch
    python tools/lint_torch/engine_lint.py src/repro_torch/serving/engine.py
    python tools/lint_torch/engine_lint.py --select EL001,EL004
    python tools/lint_torch/engine_lint.py --list-rules

Exit 0 when clean, 1 on any violation (or unparsable file), 2 on an
unknown rule id or a missing path. Rule docs:
docs/static-analysis-torch.md; pragma grammar (shared with tools/lint):
``# el: allow[tag] -- reason``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

# runnable from the repo root without installing anything
_ROOT = Path(__file__).resolve().parent.parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from tools.lint.engine_lint import collect_files, run  # noqa: E402
from tools.lint.framework import Rule  # noqa: E402
from tools.lint_torch.rules import ALL_RULES  # noqa: E402

DEFAULT_PATHS = ("src/repro_torch",)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="engine invariant linter for the PyTorch port "
                    "(see docs/static-analysis-torch.md)")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories to lint "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    rules: list[Rule] = [cls() for cls in ALL_RULES]
    if args.list_rules:
        for rule in rules:
            print(f"{rule.rule_id} (pragma: {rule.pragma_tag}): "
                  f"{rule.description}")
        return 0
    if args.select:
        wanted = {r.strip().upper() for r in args.select.split(",")}
        unknown = wanted - {r.rule_id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.rule_id in wanted]

    paths = [Path(p) if Path(p).is_absolute() else _ROOT / p
             for p in args.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        for p in missing:
            print(f"{p}: no such file or directory", file=sys.stderr)
        return 2

    violations = run(paths, _ROOT, rules)
    for v in violations:
        print(v.render())
    print(f"# engine_lint: {len(collect_files(paths))} files, "
          f"{len(rules)} rules, {len(violations)} violations",
          file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
