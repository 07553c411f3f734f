"""Drive the lint layers over a plan set and assemble the report.

Per plan (and, for armed suites, per arming variant):

1. plan lint: predict the groups, explain and judge every split;
2. dispatch lint: each group's route on the card (chunk kernel or the
   counted per-tick path), float32-only operands;
3. launch-contract lint, static part: each chunk-kernel group's
   specialization, shared memory, threads and operands;
4. accounting: each predicted group runs once, cut to its first chunk
   (``sim_time / n_chunks``, one chunk: the point's widths and
   specialization unchanged), inside `counters.watch`.  Runs must equal the
   groups predicted, exactly (``plan/group-mismatch``); on the card the
   chunk kernel's launches must equal the groups expected on it, one each,
   with no fallback (``dispatch/kernel-missing``).  A group whose kernel
   layout the cut would change runs at plan depth instead, and the proof
   says how many did.  On the card the launch-contract lint then reads the
   library for these runs' specializations, and the budget book (opt-in
   via ``budgets=``) records each group's envelope: the static leaves at
   plan depth, the card's from the run.

The accounting is the only layer that executes; it runs on the card
unless the caller passes ``device="cpu"`` (the tests do).  The port has no
program cache, so the JAX package's cold/warm distinction
(``expect_cold``) has no meaning here: the parameter is kept for the
CLI's shape and changes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.analysis import (dispatch_lint, kernel_lint, plan_lint,
                                  source_lint)
from repro_torch.analysis.budget import (BudgetBook, card_envelope,
                                         static_envelope)
from repro_torch.analysis.findings import AnalysisReport, make_finding

__all__ = ["analyze_plan", "run_analysis", "cut_to_one_chunk",
           "check_launches"]


def cut_to_one_chunk(cfg):
    """The group's config cut to its first chunk: the same ticks per chunk,
    widths and specialization, one chunk."""
    return dataclasses.replace(cfg, sim_time=cfg.sim_time / cfg.n_chunks,
                               n_chunks=1)


def check_launches(label: str, launches: int, fallbacks: int,
                   chunks: int = 1) -> list:
    """``dispatch/kernel-missing`` unless the run of a group expected on
    the chunk kernel launched it once a chunk with no fallback."""
    if launches == chunks and fallbacks == 0:
        return []
    return [make_finding(
        "dispatch/kernel-missing", label,
        f"expected {chunks} chunk-kernel launch(es) and no fallback, the "
        f"run made {launches} launch(es) and {fallbacks} fallback(s)")]


def _layout(cfg):
    from repro_torch.kernels import netsim_chunk as nc

    return nc.shape_of(cfg), nc.telemetry_layout(cfg), nc.armed_bits(cfg)


def _analyze_variant(label: str, plan, telemetry, *, pad_jobs: bool,
                     report: AnalysisReport, device,
                     budgets: Optional[BudgetBook]) -> None:
    import torch

    from repro_torch import device as device_mod
    from repro_torch.netsim import counters, engine, experiment

    dev = device_mod.resolve(device)
    on_card = dev.type == "cuda"
    findings, pfacts = plan_lint.lint_plan(
        plan, label=label, pad_jobs=pad_jobs, telemetry=telemetry)
    report.extend(findings)
    points, cfgs, overrides, groups = pfacts.pop("_resolved")

    # static layers, on the CPU
    static = []
    for gi, group in enumerate(groups):
        glabel = f"{label}/group{gi}"
        sweep = experiment.group_sweep(cfgs, overrides, group, device="cpu")
        state = dispatch_lint.initial_state(group.cfg, sweep)
        df, dfacts = dispatch_lint.lint_dispatch(group.cfg, sweep,
                                                 label=glabel,
                                                 state=state[2])
        report.extend(df)
        setup = kfacts = None
        if dfacts["expectation"] == "chunk":
            setup = kernel_lint.launch_setup(group.cfg, sweep, state)
            kf, kfacts = kernel_lint.lint_kernel(group.cfg, sweep,
                                                 label=glabel, setup=setup)
            report.extend(kf)
        static.append((glabel, sweep, dfacts, setup, kfacts))

    # accounting: every group once, one chunk each
    full_depth = 0
    runs = []
    with counters.watch() as w:
        for group, (glabel, sweep, dfacts, setup, kfacts) in zip(groups,
                                                                  static):
            cfg = cut_to_one_chunk(group.cfg)
            if _layout(cfg) != _layout(group.cfg):
                cfg, full_depth = group.cfg, full_depth + 1
            run_sweep = engine.SweepParams(*[None if v is None else v.to(dev)
                                             for v in sweep])
            peak = None
            with counters.watch() as gw:
                if on_card:
                    torch.cuda.synchronize(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    base = torch.cuda.memory_allocated(dev)
                engine.simulate_sweep(cfg, run_sweep, device=dev)
                if on_card:
                    torch.cuda.synchronize(dev)
                    peak = int(torch.cuda.max_memory_allocated(dev) - base)
            runs.append(dict(launches=gw.launches, fallbacks=gw.fallbacks,
                             peak=peak, chunks=cfg.n_ticks // max(
                                 1, cfg.n_ticks // cfg.n_chunks)))
    ran, launches, fallbacks = w.traces, w.launches, w.fallbacks

    if ran != len(groups):
        report.extend([make_finding(
            "plan/group-mismatch", label,
            f"predicted {len(groups)} group(s) but running them made {ran} "
            f"run(s) of engine.run_ticks")])

    expected = [s[2]["expectation"] == "chunk" for s in static]
    built = kernel_lint.built_specializations()
    proven = 0
    smem_peak = regs_peak = spill_total = 0
    for gi, (group, (glabel, sweep, dfacts, setup, kfacts), r) in enumerate(
            zip(groups, static, runs)):
        if on_card and expected[gi]:
            missing = check_launches(glabel, r["launches"], r["fallbacks"],
                                     r["chunks"])
            report.extend(missing)
            proven += not missing
        if setup is None:
            continue
        if on_card and tuple(kfacts["specialization"]) in built:
            lf, lfacts = kernel_lint.lint_library(group.cfg, sweep,
                                                  label=glabel, setup=setup)
            report.extend(lf)
            kfacts.update(lfacts)
            regs_peak = max(regs_peak, lfacts["registers"])
            spill_total += lfacts["local_bytes"]
        smem_peak = max(smem_peak, kfacts["smem_bytes"])
        if budgets is not None:
            env = static_envelope(group.cfg, setup)
            if on_card:
                env.update(card_envelope(kfacts, r["peak"]))
            budgets.observe(
                label,
                f"group{gi}|{experiment._group_signature(group)}", env)

    report.proofs[label] = {
        "points": len(points),
        "groups_predicted": len(groups),
        "groups_run": ran,
        "kernel_groups_expected": sum(expected),
        "kernel_groups_proven": proven if on_card else None,
        "kernel_fallbacks": fallbacks,
        "f64_operands": sum(s[2]["f64_operands"] for s in static),
        "launches": launches,
        "smem_bytes_peak": smem_peak,
        "registers_peak": regs_peak if on_card else None,
        "spill_bytes": spill_total if on_card else None,
        "groups_at_full_depth": full_depth,
        "wasted_runs_estimate": pfacts["wasted_runs_estimate"],
        "device": dev.type,
    }


def analyze_plan(name: str, plan, *, telemetry=None, lint_unarmed=False,
                 pad_jobs: bool = True, expect_cold: bool = False,
                 report: AnalysisReport = None, device=None,
                 budgets: Optional[BudgetBook] = None) -> AnalysisReport:
    """All per-plan proofs for one plan; returns/extends the report.
    Pass a `BudgetBook` to also record each group's envelope (the caller
    `finish()`es or `save()`s the book).  ``expect_cold`` changes nothing
    (the port has no program cache); runs go on the card unless
    ``device="cpu"``."""
    del expect_cold
    if report is None:
        report = AnalysisReport()
    variants = [(name, telemetry)]
    if telemetry is not None and lint_unarmed:
        variants.append((f"{name}[unarmed]", None))
    for label, telem in variants:
        _analyze_variant(label, plan, telem, pad_jobs=pad_jobs,
                         report=report, device=device, budgets=budgets)
    return report


def run_analysis(plan_names=(), *, source: bool = True,
                 expect_cold: bool = False, profile: Optional[str] = None,
                 device=None,
                 budgets: Optional[BudgetBook] = None) -> AnalysisReport:
    """The CLI entry: named plans (registry) and the source lint.

    ``profile`` stamps the report's severity profile (ci/bench/notebook);
    ``budgets`` arms the budget layer: in check mode its findings land in
    the report, in update mode the caller `save()`s afterwards.  Plans run
    on the card unless ``device="cpu"``.
    """
    from repro_torch.analysis import plans as plan_registry

    report = AnalysisReport(profile=profile)
    for name in plan_names:
        plan, telemetry, lint_unarmed = plan_registry.resolve_entry(name)
        analyze_plan(name, plan, telemetry=telemetry,
                     lint_unarmed=lint_unarmed, expect_cold=expect_cold,
                     report=report, device=device, budgets=budgets)
    if budgets is not None and not budgets.update:
        report.extend(budgets.finish())
    if source:
        findings, facts = source_lint.lint_paths()
        report.extend(findings)
        report.proofs["source"] = facts
    return report
