"""repro_torch.analysis: the port's static verifier of the simulator.

Proves, before a plan's results are trusted: every group split is
explained and the groups predicted are the runs made (plan lint and the
accounting), every group takes the chunk kernel on the card with float32
operands only (dispatch lint), the kernel's launch is a built
specialization that fits the card and gets the operands it indexes
(launch-contract lint), the sources are free of the bug patterns that cost
the card or break the float32 parity (host read-backs in the tick loop,
float64, unit-suffix mixups, stale pragmas, double arithmetic in the CUDA
sources), and every group's launch envelope matches the committed
baseline (budgets).  One report, one CLI::

    PYTHONPATH=src python -m repro_torch.analysis              # source lint
    PYTHONPATH=src python -m repro_torch.analysis --ci         # on the card

It is the port of ``repro/analysis`` (the JAX package's five-layer
verifier); `findings.REFERENCE_RULES` maps each of that package's rules to
the port's.  Severity profiles (``ci`` / ``bench`` / ``notebook``)
re-weight the same catalog per consumer.
"""
from repro_torch.analysis.budget import (BudgetBook, DEFAULT_TOLERANCES,
                                         env_fingerprint, static_envelope)
from repro_torch.analysis.dispatch_lint import (kernel_expectation,
                                                lint_dispatch)
from repro_torch.analysis.findings import (AnalysisReport, Finding, PROFILES,
                                           REFERENCE_RULES, Rule, RULES,
                                           make_finding, severity_for)
from repro_torch.analysis.kernel_lint import (launch_setup, lint_kernel,
                                              lint_library)
from repro_torch.analysis.plan_lint import (lint_plan, predict_compile_groups,
                                            STRUCTURAL_FIELDS)
from repro_torch.analysis.plans import CI_PLANS, PLANS, resolve_entry
from repro_torch.analysis.runner import analyze_plan, run_analysis
from repro_torch.analysis.source_lint import lint_paths, lint_sources

__all__ = [
    "AnalysisReport", "Finding", "PROFILES", "REFERENCE_RULES", "Rule",
    "RULES", "make_finding", "severity_for",
    "BudgetBook", "DEFAULT_TOLERANCES", "env_fingerprint", "static_envelope",
    "kernel_expectation", "lint_dispatch",
    "launch_setup", "lint_kernel", "lint_library",
    "lint_plan", "predict_compile_groups", "STRUCTURAL_FIELDS",
    "CI_PLANS", "PLANS", "resolve_entry",
    "analyze_plan", "run_analysis",
    "lint_paths", "lint_sources",
]
