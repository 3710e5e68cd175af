#!/usr/bin/env python
"""torchlint runner: the port's static checks over sml_tpu_torch/,
chip_smoke.py and scripts/torch_*.py.

Loads `sml_tpu_torch/lint/` STANDALONE (importlib by path, package name
"torchlint"), so a lint run imports none of torch, jax, sml_tpu or
sml_tpu_torch and finishes from a cold interpreter in about a second.

Exit-code contract (relied on by chip_smoke.py's lint phase and the
tests; do not reuse these codes for anything else):

    0  clean: no unsuppressed violations (also: --list-rules,
       --update-baseline success)
    1  violations found (pragma and baseline hygiene findings included)
    2  usage or internal error (unknown --rule, unreadable tree, a rule
       crashing, a bad --changed-only ref); argparse errors exit 2 too

Suppress one line with `# torchlint: disable=<rule> -- <reason>`, or
carry a reviewed debt in sml_tpu_torch/lint/baseline.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG_NAME = "torchlint"


def load_linter():
    """sml_tpu_torch/lint as a standalone top-level package."""
    if PKG_NAME in sys.modules:
        return sys.modules[PKG_NAME]
    pkg_dir = os.path.join(REPO, "sml_tpu_torch", "lint")
    spec = importlib.util.spec_from_file_location(
        PKG_NAME, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PKG_NAME] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="torchlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the active rule catalogue and exit")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="NAME",
                        help="run only this rule (repeatable)")
    parser.add_argument("--changed-only", metavar="GIT_REF", default=None,
                        help="report only violations in files changed vs "
                             "GIT_REF (plus untracked files); the whole "
                             "tree is still analysed (cross-file rules "
                             "need it), only the REPORT is filtered")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore sml_tpu_torch/lint/baseline.json")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current violations "
                             "(new entries get a TODO reason the lint then "
                             "flags until it is replaced by a reviewed one)")
    parser.add_argument("--root", default=REPO, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    lint = load_linter()

    if args.list_rules:
        for name in sorted(lint.RULES):
            print(f"{name:<30} {lint.RULES[name].doc}")
        return 0

    try:
        # --update-baseline must see the UNSUPPRESSED violations: a
        # rebuild from a baseline-filtered report would erase every
        # still-valid reviewed entry
        report = lint.run(root=args.root, rule_names=args.rule,
                          use_baseline=(not args.no_baseline
                                        and not args.update_baseline))
    except KeyError as e:
        print(f"torchlint: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # internal error (a rule crashed): contract = 2
        print(f"torchlint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    if args.changed_only is not None:
        try:
            changed = _changed_files(args.root, args.changed_only)
        except Exception as e:  # bad ref / not a git tree: contract = 2
            print(f"torchlint: --changed-only: {e}", file=sys.stderr)
            return 2
        report = lint.Report(
            [v for v in report.violations if v.path in changed],
            report.rule_names, report.n_files,
            n_suppressed_pragma=report.n_suppressed_pragma,
            n_suppressed_baseline=report.n_suppressed_baseline,
            rule_times=report.rule_times,
            suppressed_detail=[(v, how) for v, how
                               in report.suppressed_detail
                               if v.path in changed])

    if args.update_baseline:
        baseline_mod = sys.modules[f"{PKG_NAME}.baseline"]
        path = os.path.join(args.root, baseline_mod.DEFAULT_BASENAME)
        suppressible = [v for v in report.violations
                        if v.rule not in lint.META_RULES]
        baseline_mod.update(path, suppressible)
        print(f"baseline rewritten: {path} ({len(suppressible)} entries; "
              f"replace the TODO reasons before committing)")
        return 0

    if args.json:
        print(json.dumps({
            "clean": report.clean,
            "rules": report.rule_names,
            "files": report.n_files,
            "changed_only": args.changed_only,
            "suppressed": {"pragma": report.n_suppressed_pragma,
                           "baseline": report.n_suppressed_baseline},
            "rule_times": {n: round(t, 6)
                           for n, t in sorted(report.rule_times.items())},
            "violations": [{"rule": v.rule, "path": v.path, "line": v.line,
                            "message": v.message, "snippet": v.snippet,
                            "status": "active"}
                           for v in report.violations],
            "suppressed_violations": [
                {"rule": v.rule, "path": v.path, "line": v.line,
                 "message": v.message, "status": how}
                for v, how in report.suppressed_detail],
        }, indent=1))
    else:
        print(report.format())
    return 0 if report.clean else 1


def _changed_files(root, ref):
    """Repo-relative paths changed vs `ref`, plus untracked files (a new
    file must still be lintable before its commit). Raises on any git
    failure; the caller maps that to exit code 2."""
    out = set()
    for cmd in (["git", "diff", "--name-only", ref, "--"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        proc = subprocess.run(cmd, cwd=root, capture_output=True,
                              text=True, timeout=30)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr.strip()
                               or f"`{' '.join(cmd)}` failed")
        out.update(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return out


if __name__ == "__main__":
    sys.exit(main())
