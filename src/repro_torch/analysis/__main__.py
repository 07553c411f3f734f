"""CLI: ``python -m repro_torch.analysis [--ci] [--plan <suite>] [...]``.

* no flags: the source lint only (fast; no card needed);
* ``--plan fig12`` (repeatable): also verify that suite's plan (registry
  names: `repro_torch.analysis.plans.PLANS`), its accounting runs on the
  card, or on the CPU with ``--device cpu``; with no card and no
  ``--device cpu`` it raises, it never carries on on the CPU unasked;
* ``--ci``: the gate: defaults the plan set to `CI_PLANS`, arms the launch
  budgets and exits 1 on any error-severity finding under the active
  profile;
* ``--profile ci|bench|notebook``: severity profile (ci promotes
  baseline-hygiene warnings to errors; notebook demotes errors to
  advisory warnings); defaults to ``ci`` under ``--ci``, else ``bench``;
* ``--update-budgets``: re-record ``analysis/budgets.json`` from this run's
  envelopes instead of checking against it (the path for intentional
  changes: run it on the card and commit the rewritten file);
* ``--report-json PATH``: also dump the machine-readable `AnalysisReport`;
* ``--list-rules``: print the rule catalog (id, layer, default severity,
  per-profile severities) and exit.
"""
from __future__ import annotations

import argparse
import sys


def _list_rules() -> str:
    from repro_torch.analysis.findings import PROFILES, RULES

    rows = [("rule", "layer", "default", *PROFILES)]
    for rid in sorted(RULES):
        r = RULES[rid]
        rows.append((rid, r.layer, r.severity,
                     *(r.severity_in(p) for p in PROFILES)))
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
             for row in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static verifier: plan, dispatch, launch-contract, "
                    "source and budget lints")
    ap.add_argument("--ci", action="store_true",
                    help="gate mode: default plan set, budget enforcement, "
                         "exit 1 on errors")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="SUITE", help="lint a named plan (repeatable)")
    ap.add_argument("--profile", choices=("ci", "bench", "notebook"),
                    default=None,
                    help="severity profile (default: ci under --ci, "
                         "else bench)")
    ap.add_argument("--no-source", action="store_true",
                    help="skip the source lint layer")
    ap.add_argument("--no-budgets", action="store_true",
                    help="skip the launch-budget layer")
    ap.add_argument("--update-budgets", action="store_true",
                    help="re-record analysis/budgets.json from this run "
                         "instead of checking against it")
    ap.add_argument("--budgets-path", default=None, metavar="PATH",
                    help="override the budgets.json location")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="also write the report as JSON")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--device", default=None,
                    help="where the accounting runs: the card (default) or "
                         "'cpu'")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print info-severity findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    from repro_torch.analysis import CI_PLANS, run_analysis
    from repro_torch.analysis.budget import DEFAULT_PATH, BudgetBook

    plan_names = list(args.plan)
    if args.ci and not plan_names:
        plan_names = list(CI_PLANS)
    profile = args.profile or ("ci" if args.ci else "bench")

    budgets = None
    want_budgets = (args.ci or args.update_budgets) and not args.no_budgets
    if want_budgets and plan_names:
        budgets = BudgetBook(path=args.budgets_path or DEFAULT_PATH,
                             update=args.update_budgets,
                             device=args.device or "cuda")

    report = run_analysis(plan_names, source=not args.no_source,
                          expect_cold=args.ci, profile=profile,
                          device=args.device, budgets=budgets)
    print(report.render(verbose=args.verbose))
    if budgets is not None and args.update_budgets:
        print(f"budgets recorded -> {budgets.save()}")
    if args.report_json:
        import json
        from pathlib import Path

        Path(args.report_json).write_text(
            json.dumps(report.to_json(), indent=1) + "\n")
    return 1 if (args.ci and not report.ok()) else 0


if __name__ == "__main__":
    sys.exit(main())
