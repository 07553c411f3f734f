"""Finding records and the analysis report: the one output surface every
lint layer (plan, dispatch, launch contract, source, budget) emits into.

A `Finding` is a structured diagnostic: a rule id (``layer/rule-name``), a
severity, a location string (``file:line`` for source findings, a
``plan/group`` label for plan, dispatch, kernel and budget findings) and a
human message.  The `AnalysisReport` aggregates findings plus per-plan
*proofs* (the positive facts the verifier established: groups predicted ==
groups run, every group through the chunk kernel, no float64 operand, the
launch envelopes within budget) and renders both; ``--ci`` exits nonzero
iff any error-severity finding survives.

**Severity profiles**: the same rule catalog serves three consumers with
different stakes.  ``severity_for(rule, profile)`` resolves a rule's
severity under a named profile: ``ci`` (the gate: suppressions and
baselines must be live, so stale-pragma / missing-baseline promote to
error), ``bench`` (the defaults), ``notebook`` (advisory: every error
demotes to warning, nothing gates).  Per-rule overrides live on the `Rule`
itself; the notebook demotion is the profile-wide fallback.

The catalog is the port's own.  `REFERENCE_RULES` maps every rule of the
JAX package's verifier (``repro/analysis/findings.py``) to the port rule
that proves the same thing on the card, or to the reason the port has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Severity", "Finding", "Rule", "AnalysisReport", "RULES",
           "PROFILES", "REFERENCE_RULES", "rule", "make_finding",
           "severity_for"]

# Severity order (render sorts errors first).
ERROR = "error"
WARNING = "warning"
INFO = "info"
Severity = str
_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

# Consumer profiles, strictest first.  "bench" is the default: rule
# severities apply as declared.
PROFILES = ("ci", "bench", "notebook")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One catalog entry: what a rule proves and why it matters."""

    id: str                 # "dispatch/f64-operand"
    severity: Severity      # default severity of its findings
    summary: str            # one line, shown in renders
    rationale: str          # why violating it invalidates results
    # per-profile severity overrides as ((profile, severity), ...) pairs
    # (a tuple keeps the dataclass frozen/hashable)
    profiles: tuple = ()

    @property
    def layer(self) -> str:
        return self.id.split("/", 1)[0]

    def severity_in(self, profile: Optional[str]) -> Severity:
        """Effective severity under a named profile (None = declared)."""
        if profile is None or profile == "bench":
            return self.severity
        over = dict(self.profiles)
        if profile in over:
            return over[profile]
        if profile == "notebook" and self.severity == ERROR:
            return WARNING          # advisory: nothing gates a notebook
        return self.severity


# The full rule catalog; tests assert every rule here fires on a
# deliberately broken fixture.
RULES: dict[str, Rule] = {}


def rule(id: str, severity: Severity, summary: str, rationale: str,
         profiles: tuple = ()) -> Rule:
    for prof, sev in profiles:
        if prof not in PROFILES or sev not in _SEV_ORDER:
            raise ValueError(f"bad profile override {(prof, sev)!r} on {id}")
    r = Rule(id=id, severity=severity, summary=summary, rationale=rationale,
             profiles=profiles)
    if id in RULES:
        raise ValueError(f"duplicate rule id {id!r}")
    RULES[id] = r
    return r


def severity_for(rule_id: str, profile: Optional[str] = None) -> Severity:
    """A rule's effective severity under a profile (None = declared)."""
    if profile is not None and profile not in PROFILES:
        raise KeyError(f"unknown profile {profile!r}; known: {PROFILES}")
    return RULES[rule_id].severity_in(profile)


# --- plan layer -----------------------------------------------------------
rule("plan/group-split", INFO,
     "two plan points run as separate groups (group-split explainer)",
     "every extra group is one more run of the chunk kernel and its "
     "launches each chunk; the explainer names the exact canonicalized "
     "fields that differ so splits are always accounted for.")
rule("plan/avoidable-split", WARNING,
     "group split on value-only fields",
     "the differing fields are plain numeric values that could ride the "
     "batched sweep as SweepParams leaves; the split costs a separate run "
     "and separate launches each chunk.")
rule("plan/group-mismatch", ERROR,
     "predicted groups != runs actually made",
     "the grouping canonicalization and `run_plan` disagree: either the "
     "prediction merges points the run splits (extra runs) or the other "
     "way round; the plan's cost and its cells would then not be what "
     "the lint proved.")

# --- dispatch layer (the route the port's wrappers take) -------------------
rule("dispatch/kernel-fallback", ERROR,
     "the card would take the counted per-tick path for this group",
     "`kernels.ops.netsim_chunk` sends a non-default favoritism without "
     "Static factors, a callable F (the kernels compute the linear F and "
     "F1..F6), a custom telemetry probe or a point "
     "over the shared-memory budget down the per-tick loop (replayed as "
     "a CUDA graph of a chunk, or eager where a Python callable runs in "
     "the tick, as the finding says); a plan that claims the chunk "
     "kernel then runs ~165 launches a tick instead of one a chunk, and "
     "its timings are void.")
rule("dispatch/f64-operand", ERROR,
     "float64 tensor among a group's sweep leaves or initial state",
     "the engine and the kernels are pinned bit for bit in float32; a "
     "float64 leaf either fails the launch contract or, on the per-tick "
     "path, silently promotes the arithmetic and breaks the kernel/plain "
     "parity.")
rule("dispatch/kernel-missing", ERROR,
     "a group expected on the chunk kernel ran without its launch",
     "on the card every group whose expectation is the chunk kernel must "
     "launch it exactly once a chunk with no fallback counted; anything "
     "else means the run took another route than the one the lint "
     "proved.")

# --- source layer ---------------------------------------------------------
rule("src/host-sync-in-loop", ERROR,
     "loop-reachable code reads a tensor back to the host",
     "`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `float()/int()/bool()` "
     "of a tensor or an `if`/`while` on one, in code that runs once a "
     "tick or once a chunk, stalls the host on the card every time: the "
     "host can no longer draw the next chunk while the card runs this "
     "one.")
rule("src/f64-literal", ERROR,
     "float64 dtype outside host-side config plumbing",
     "torch.float64 / .double() anywhere, or np.float64 / 'float64' in "
     "loop-reachable code, promotes the bit-stable float32 pipeline; "
     "np.float64 is fine only in numpy-side config plumbing that never "
     "reaches a tick.")
rule("src/unit-suffix", ERROR,
     "add/subtract/compare across conflicting unit suffixes",
     "names suffixed _bytes/_s/_bps/_ticks carry units; summing or "
     "comparing across units (without a converting multiply/divide) is "
     "the classic silent protocol-parameter bug the RoCE CC sensitivity "
     "studies warn about.")
rule("src/stale-pragma", WARNING,
     "`# lint: allow(rule)` pragma that no longer suppresses anything",
     "a suppression must not outlive the code it excused: a pragma naming "
     "an unknown rule, or a rule that no longer fires on its line, is dead "
     "weight that will silently swallow the next real finding there.",
     profiles=(("ci", ERROR),))
rule("src/cu-double", ERROR,
     "`double` or an unsuffixed floating literal in a CUDA source",
     "C++ evaluates `x * 0.5` in double: the expression is promoted to "
     "FP64, rounds differently from the float32 PyTorch op it repeats and "
     "breaks the kernel's bitwise parity with its plain version.  A "
     "constant expression of literals directly under an explicit "
     "`(float)` cast passes (the compiler folds it to one float32 "
     "constant, as `(float)(1.0 / 3.0)` in mltcp_cc.cuh); anything else "
     "takes an `f` suffix or the pragma `// lint: allow(cu-double)`.")

# --- kernel layer (the chunk kernel's launch contract) --------------------
rule("kernel/unbuilt-specialization", ERROR,
     "(algo, variant, aggregate, factors, ARMED) is not a built "
     "specialization",
     "the library runs the 48 CC specializations unarmed and under each "
     "ARMED (`kernel_lint.built_specializations`); any other launch is "
     "refused by the library's dispatch.")
rule("kernel/smem-budget", ERROR,
     "a point's shared memory exceeds the ceiling or the card's limit",
     "one CTA holds one point's whole state in shared memory; over "
     "SMEM_LIMIT the launch cannot run, and over the configurable ceiling "
     "fewer CTAs fit an SM, so a wide sweep serializes.")
rule("kernel/smem-mismatch", ERROR,
     "the library's launch shared memory != the Python prediction",
     "`netsim_chunk.smem_bytes` is the budget the dispatch decides on; if "
     "the library asks for another size the budget check proves nothing "
     "about the launch that actually runs.")
rule("kernel/threads", ERROR,
     "the CTA's threads exceed MAX_THREADS or the kernel's limit",
     "`threads_for` must stay within the kernel's __launch_bounds__ "
     "(MAX_THREADS) and the runtime's max threads per block for the "
     "specialization, or the launch is refused.")
rule("kernel/operand-mismatch", ERROR,
     "an operand's dtype, shape or layout differs from the contract",
     "the kernel indexes its operands by the packed layout "
     "(`prepare`, `pack_state`, `chunk_inputs`, `new_traces`); a wrong "
     "dtype, shape or a non-contiguous buffer reads the wrong words.")
rule("kernel/spill", ERROR,
     "the specialization spills registers to local memory",
     "the chunk kernel's latency-bound tick chain is sized to stay in "
     "registers; local-memory spills add a memory round trip to every "
     "dependent step.")

# --- budget layer (per-group launch envelopes) ----------------------------
rule("budget/drift", ERROR,
     "a group's launch envelope drifted beyond tolerance vs the baseline",
     "CTAs, threads, shared memory, launches, operand and trace bytes, "
     "registers, spills and the run's peak memory per group are pinned in "
     "analysis/budgets.json; unexplained drift means a change altered "
     "what a run costs the card; fix it or re-record with "
     "--update-budgets.")
rule("budget/missing-baseline", WARNING,
     "group has no baseline entry in budgets.json",
     "an unpinned group's cost can regress silently; record it with "
     "`python -m repro_torch.analysis --ci --update-budgets` on the card "
     "(plans or groups can legitimately be new, hence warning outside "
     "CI).",
     profiles=(("ci", ERROR),))
rule("budget/stale-baseline", WARNING,
     "budgets.json pins groups the plan no longer produces",
     "a stale baseline entry means the plan's group structure changed "
     "without re-recording; the remaining pins may compare unlike runs.",
     profiles=(("ci", ERROR),))
rule("budget/env-mismatch", WARNING,
     "budgets.json was recorded under a different environment",
     "the envelope depends on the plans' depth (REPRO_SMOKE/REPRO_FULL), "
     "the card, torch, the CUDA runtime and nvcc; comparing across "
     "environments would flag phantom drift, so budget checks are skipped "
     "(re-record in this environment to re-arm them).")


# Every rule of the JAX package's verifier, to the port rule that proves
# the same thing here, or to why the port has none.
REFERENCE_RULES: dict[str, str] = {
    "ir/kernel-missing": "dispatch/kernel-missing",
    "ir/kernel-fallback": "dispatch/kernel-fallback",
    "ir/kernel-unexpected":
        "none: the port has no kernel-off configuration to keep clean "
        "(SimConfig has no use_pallas_kernel; the plain per-tick path, "
        "graphed on the card, is asked for only by "
        "engine.run_ticks(per_tick=True), and its eager loop by "
        "engine.run_ticks(eager=True))",
    "ir/f64-promotion": "dispatch/f64-operand",
    "ir/host-callback": "src/host-sync-in-loop",
    "ir/nested-control":
        "none: the port traces no program, so it has no traced control "
        "flow; the tick loop is host Python and the kernel's branches are "
        "template parameters",
    "plan/group-split": "plan/group-split",
    "plan/avoidable-split": "plan/avoidable-split",
    "plan/group-mismatch": "plan/group-mismatch",
    "plan/retrace":
        "none: the port has no program cache to miss; every "
        "simulate_sweep is one run, counted exactly by plan/group-mismatch",
    "src/np-in-scan":
        "none: the tick loop is host code, where numpy is legitimate "
        "(netsim.random draws a chunk with numpy by design); what costs "
        "the card is a read-back, src/host-sync-in-loop",
    "src/float-cast-traced": "src/host-sync-in-loop",
    "src/branch-on-traced": "src/host-sync-in-loop",
    "src/f64-literal": "src/f64-literal",
    "src/unit-suffix": "src/unit-suffix",
    "src/stale-pragma": "src/stale-pragma",
    "kernel/dyn-not-smem":
        "none: the port has no SMEM-space operand; the protocol scalars "
        "are each point's row of the [K, 9] params operand "
        "(kernel/operand-mismatch holds its shape and dtype)",
    "kernel/dyn-written":
        "none: the kernel reads the params operand through a const "
        "pointer (netsim_chunk.cu g_params), so a store does not compile",
    "kernel/state-not-vmem": "kernel/smem-mismatch",
    "kernel/block-misaligned":
        "none: the chunk kernel has no block tiling; one CTA runs one "
        "whole point, and operand shapes are held by "
        "kernel/operand-mismatch",
    "kernel/grid-remainder":
        "none: the grid is K CTAs, one per sweep point, by construction "
        "(netsim_chunk_launch), so no remainder step exists",
    "kernel/operand-mismatch": "kernel/operand-mismatch",
    "kernel/f64-in-body": "src/cu-double",
    "kernel/gather-scatter":
        "none: the chunk kernel gathers and scatters by design (routing, "
        "per-job folds in shared memory); the one-pass elementwise tile "
        "was the TPU kernel's shape, not this one's",
    "kernel/nested-control":
        "none: the chunk kernel loops over a chunk's ticks by design; its "
        "specialization is template parameters (the armed kernel's CC "
        "selections are launch dims), checked by "
        "kernel/unbuilt-specialization",
    "kernel/vmem-budget": "kernel/smem-budget",
    "budget/drift": "budget/drift",
    "budget/missing-baseline": "budget/missing-baseline",
    "budget/stale-baseline": "budget/stale-baseline",
    "budget/env-mismatch": "budget/env-mismatch",
    "budget/unknown-dtype":
        "none: no HLO text is parsed; every byte count comes from a "
        "tensor's own element size",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from any lint layer."""

    rule: str               # a RULES key
    where: str              # "src/...py:123" | "fig12/group0" | plan name
    message: str
    severity: Optional[Severity] = None   # None: the rule's default

    @property
    def effective_severity(self) -> Severity:
        return self.severity_under(None)

    def severity_under(self, profile: Optional[str]) -> Severity:
        """Effective severity under a profile; an explicit per-finding
        severity (a downgrade a layer chose deliberately) always wins."""
        if self.severity is not None:
            return self.severity
        return severity_for(self.rule, profile)


def make_finding(rule_id: str, where: str, message: str,
                 severity: Optional[Severity] = None) -> Finding:
    if rule_id not in RULES:
        raise KeyError(f"unknown rule {rule_id!r}")
    return Finding(rule=rule_id, where=where, message=message,
                   severity=severity)


@dataclasses.dataclass
class AnalysisReport:
    """Findings from every layer plus the positive proofs per analyzed plan.

    ``profile`` selects the severity profile every aggregate view
    (``errors``/``warnings``/``ok``/``render``/``to_json``) resolves
    through; None keeps each rule's declared severity (== "bench").
    """

    findings: list[Finding] = dataclasses.field(default_factory=list)
    # plan/fixture name -> established facts, e.g. {"groups_predicted": 2,
    # "groups_run": 2, "kernel_groups_proven": 2, "f64_operands": 0}
    proofs: dict = dataclasses.field(default_factory=dict)
    profile: Optional[str] = None

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def severity_of(self, f: Finding) -> Severity:
        return f.severity_under(self.profile)

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if self.severity_of(f) == ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if self.severity_of(f) == WARNING]

    def ok(self) -> bool:
        return not self.errors()

    def render(self, verbose: bool = False) -> str:
        lines = []
        shown = sorted(
            self.findings,
            key=lambda f: (_SEV_ORDER[self.severity_of(f)], f.rule, f.where))
        if not verbose:
            shown = [f for f in shown if self.severity_of(f) != INFO]
        for f in shown:
            lines.append(f"{self.severity_of(f).upper():7s} {f.rule:24s} "
                         f"{f.where}: {f.message}")
        for name in sorted(self.proofs):
            facts = self.proofs[name]
            body = ", ".join(f"{k}={v}" for k, v in facts.items())
            lines.append(f"PROOF   {name}: {body}")
        n_err, n_warn = len(self.errors()), len(self.warnings())
        n_info = len(self.findings) - n_err - n_warn
        prof = f" [profile={self.profile}]" if self.profile else ""
        lines.append(f"== {n_err} errors, {n_warn} warnings, {n_info} info; "
                     f"{'FAIL' if n_err else 'PASS'}{prof}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        """JSON-serializable dump (the CI workflow-artifact surface)."""
        return {
            "profile": self.profile,
            "ok": self.ok(),
            "findings": [
                {"rule": f.rule, "where": f.where, "message": f.message,
                 "severity": self.severity_of(f)}
                for f in self.findings],
            "proofs": self.proofs,
            "counts": {"errors": len(self.errors()),
                       "warnings": len(self.warnings()),
                       "total": len(self.findings)},
        }
