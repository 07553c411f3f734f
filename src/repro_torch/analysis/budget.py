"""Launch budgets: pin every group's launch envelope against a
schema-versioned baseline (the port's counterpart of the JAX package's
HLO cost budgets, ``repro/analysis/hlo_budget.py``).

The envelope of a group has two halves:

* exact and device-independent, from the launch the group's run prepares
  at plan depth (`kernel_lint.launch_setup`), tolerance 0: ``ctas`` (K,
  one CTA a point), ``threads``, ``smem_bytes`` (a point's dynamic shared
  memory), ``launches`` (the run's chunks), ``operand_bytes`` (the
  `RunOperands` and `ChunkState` tensors) and ``trace_bytes`` (the trace
  buffers the kernel's epilogue writes);
* from the card, for the runner's one-chunk accounting run:
  ``registers``, ``local_bytes`` and ``static_smem_bytes`` of the
  specialization (tolerance 0) and ``peak_bytes``, the card memory the
  run added at its peak (`torch.cuda.max_memory_allocated`, tolerance
  0.25: the caching allocator's rounding).

No time is budgeted.  The envelope is compared leaf by leaf against
``budgets.json`` (committed next to this module): a metric that drifts
beyond its tolerance raises ``budget/drift`` naming the plan, the group
and the metric.

Baseline discipline, as in the JAX package:

* the file records an environment fingerprint (REPRO_SMOKE/REPRO_FULL,
  torch, the CUDA runtime, the device, nvcc); a mismatched environment
  downgrades every compare to one ``budget/env-mismatch`` warning rather
  than flagging phantom drift;
* groups the run has but the baseline lacks raise
  ``budget/missing-baseline``; baseline groups no longer produced raise
  ``budget/stale-baseline``: both warnings, errors under the ci profile;
* intentional changes re-record on the card via
  ``python -m repro_torch.analysis --ci --update-budgets`` (or the
  ``analysis`` phase of ``chip_smoke.py``, which prints the book it
  observed: commit it as printed).

Group identity is ``group<i>|`` + `experiment._group_signature`, qualified
by the plan label.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
from pathlib import Path
from typing import Optional

from repro_torch.analysis.findings import Finding, make_finding

__all__ = ["SCHEMA", "DEFAULT_PATH", "METRICS", "STATIC_METRICS",
           "CARD_METRICS", "DEFAULT_TOLERANCES", "env_fingerprint",
           "static_envelope", "card_envelope", "group_envelope",
           "check_envelope",
           "BudgetBook"]

SCHEMA = 1

# Committed next to the module so `python -m repro_torch.analysis --ci`
# finds it from any cwd and the baseline travels with the code it
# describes.
DEFAULT_PATH = Path(__file__).with_name("budgets.json")

# The leaves any device computes for a group, exactly.
STATIC_METRICS = ("ctas", "threads", "smem_bytes", "launches",
                  "operand_bytes", "trace_bytes")
# The leaves only the card reports.
CARD_METRICS = ("registers", "local_bytes", "static_smem_bytes",
                "peak_bytes")
# Per-metric relative tolerance: |new - base| <= tol * max(|base|, 1).
DEFAULT_TOLERANCES = {**dict.fromkeys(STATIC_METRICS, 0.0),
                      "registers": 0.0, "local_bytes": 0.0,
                      "static_smem_bytes": 0.0, "peak_bytes": 0.25}
METRICS = tuple(DEFAULT_TOLERANCES)


@functools.lru_cache(maxsize=1)
def _nvcc_version() -> str:
    """nvcc's release line ("" where there is no nvcc)."""
    from repro_torch.kernels import build

    try:
        out = subprocess.run([build.nvcc_path(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    m = re.search(r"release [^\n]*", out)
    return m.group(0) if m else ""


def env_fingerprint(device: str = "cuda") -> dict:
    """What the recorded numbers depend on besides the code: the plans'
    depth, torch, the CUDA runtime, the device ("cpu" or the card's name)
    and nvcc."""
    import torch

    on_card = device != "cpu" and torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "nvcc": _nvcc_version() if on_card else "",
        "repro_smoke": os.environ.get("REPRO_SMOKE", ""),
        "repro_full": os.environ.get("REPRO_FULL", ""),
    }


def _nbytes(tree) -> int:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(x) for x in tree)
    return 0


def static_envelope(cfg, setup) -> dict:
    """The device-independent leaves of a group's envelope from its
    `kernel_lint.LaunchSetup` (plan depth)."""
    from repro_torch.kernels import netsim_chunk as nc

    shape = nc.shape_of(cfg)
    run = setup.run
    return dict(
        ctas=run.dims["D_K"], threads=run.threads,
        smem_bytes=nc.smem_bytes(**shape), launches=setup.n_chunks,
        operand_bytes=_nbytes(tuple(run)) + _nbytes(tuple(setup.cs)),
        trace_bytes=_nbytes(setup.traces))


def group_envelope(cfg, sweep) -> Optional[dict]:
    """A group's envelope as `netsim.run_plan(..., profile=True)` records
    it (`GroupProfile.cost_envelope`): the static leaves for the group's
    run at its own depth and, on the card, the specialization's registers,
    local and static shared bytes.  The run's peak memory stays in
    ``GroupProfile.device_bytes``: a baseline's ``peak_bytes`` is the
    one-chunk accounting run's.  None for a group that does not take the
    chunk kernel on the card."""
    from repro_torch.analysis import dispatch_lint, kernel_lint
    from repro_torch.kernels import netsim_chunk as nc

    try:
        if dispatch_lint.kernel_expectation(cfg, sweep) != "chunk":
            return None
    except ValueError:
        return None
    env = static_envelope(cfg, kernel_lint.launch_setup(cfg, sweep))
    if sweep.slope.device.type == "cuda":
        spec = kernel_lint.specialization_of(cfg, sweep)
        env.update(card_envelope(nc.kernel_attributes(*spec), None))
    return env


def card_envelope(attrs: dict, peak_bytes: Optional[int]) -> dict:
    """The card's leaves: the specialization's `kernel_attributes` and the
    accounting run's peak (None leaves are left out)."""
    out = {k: attrs.get(k) for k in ("registers", "local_bytes",
                                     "static_smem_bytes")}
    out["peak_bytes"] = peak_bytes
    return {k: v for k, v in out.items() if v is not None}


def check_envelope(base: dict, new: dict, tolerances: dict,
                   *, where: str) -> list[Finding]:
    """Leaf-level drift compare of one group's envelope vs its baseline,
    over the metrics both carry."""
    findings = []
    for metric in METRICS:
        if metric not in base or new.get(metric) is None:
            continue
        tol = tolerances.get(metric, 0.0)
        b, n = float(base[metric]), float(new[metric])
        if abs(n - b) > tol * max(abs(b), 1.0):
            pct = (n - b) / b * 100.0 if b else float("inf")
            findings.append(make_finding(
                "budget/drift", where,
                f"{metric}: measured {n:.6g} vs baseline {b:.6g} "
                f"({pct:+.1f}%, tolerance ±{tol * 100:.0f}%); "
                f"re-record with --update-budgets if intentional"))
    return findings


@dataclasses.dataclass
class BudgetBook:
    """One analysis run's budget ledger: observe envelopes, then
    `finish()` into findings (check mode) or `save()` a new baseline
    (update mode).  ``device`` is where the run's envelopes come from
    ("cuda" or "cpu"); it enters the fingerprint."""

    path: Path = DEFAULT_PATH
    update: bool = False
    tolerances: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_TOLERANCES))
    device: str = "cuda"

    def __post_init__(self):
        self.path = Path(self.path)
        self._measured: dict[str, dict[str, dict]] = {}   # plan -> sig -> env
        self._baseline: Optional[dict] = None
        self._load_error: Optional[str] = None
        if self.path.exists():
            try:
                data = json.loads(self.path.read_text())
                if data.get("schema") != SCHEMA:
                    self._load_error = (f"schema {data.get('schema')!r} "
                                        f"!= supported {SCHEMA}")
                else:
                    self._baseline = data
                    self.tolerances = dict(DEFAULT_TOLERANCES,
                                           **data.get("tolerances", {}))
            except (OSError, json.JSONDecodeError) as e:
                self._load_error = str(e)

    # -- recording --------------------------------------------------------

    def observe(self, plan: str, signature: str, envelope: dict) -> None:
        self._measured.setdefault(plan, {})[signature] = {
            m: envelope[m] for m in METRICS if envelope.get(m) is not None}

    # -- check mode -------------------------------------------------------

    @property
    def env_matches(self) -> bool:
        if self._baseline is None:
            return False
        return self._baseline.get("env") == env_fingerprint(self.device)

    def finish(self) -> list[Finding]:
        """All budget findings for the observed run (check mode)."""
        findings: list[Finding] = []
        if self._baseline is None:
            why = (f"cannot read {self.path} ({self._load_error})"
                   if self._load_error else f"{self.path} does not exist")
            findings.append(make_finding(
                "budget/missing-baseline", "budgets",
                f"no launch baseline: {why}; record one with "
                f"--update-budgets"))
            return findings
        if not self.env_matches:
            findings.append(make_finding(
                "budget/env-mismatch", "budgets",
                f"baseline recorded under {self._baseline.get('env')} but "
                f"running under {env_fingerprint(self.device)}: drift "
                f"compares skipped (re-record in this environment to "
                f"re-arm)"))
            return findings
        base_plans = self._baseline.get("plans", {})
        for plan, groups in self._measured.items():
            base_groups = {g["signature"]: g
                           for g in base_plans.get(plan, {}).get("groups", [])}
            for sig, env in groups.items():
                where = f"{plan} :: {sig}"
                if sig not in base_groups:
                    findings.append(make_finding(
                        "budget/missing-baseline", where,
                        "group has no recorded baseline; record with "
                        "--update-budgets"))
                    continue
                findings.extend(check_envelope(
                    base_groups[sig], env, self.tolerances, where=where))
            for sig in base_groups:
                if sig not in groups:
                    findings.append(make_finding(
                        "budget/stale-baseline", f"{plan} :: {sig}",
                        "baseline group no longer produced by this plan; "
                        "prune with --update-budgets"))
        return findings

    # -- update mode ------------------------------------------------------

    def to_json(self) -> dict:
        """The observed envelopes as a baseline file's content."""
        plans = {
            plan: {"groups": [dict(signature=sig, **env)
                              for sig, env in groups.items()]}
            for plan, groups in sorted(self._measured.items())
        }
        return {"schema": SCHEMA, "env": env_fingerprint(self.device),
                "tolerances": self.tolerances, "plans": plans}

    def save(self) -> Path:
        """Write the observed envelopes as the new baseline."""
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True)
                       + "\n")
        os.replace(tmp, self.path)
        return self.path

    # -- profile cross-check ----------------------------------------------

    def matches_any(self, signature: str, envelope: dict) -> Optional[bool]:
        """Does a measured envelope (`GroupProfile.cost_envelope`) match,
        within tolerance and over the leaves both carry, any recorded group
        of the same structural signature?  Candidates come from every
        recorded plan, keyed on the `_group_signature` tail of the stored
        ``"group<i>|<signature>"`` id.  None when there is no baseline,
        the environment differs, or no candidate shares the signature."""
        if self._baseline is None or not self.env_matches:
            return None
        candidates = [
            g for plan in self._baseline.get("plans", {}).values()
            for g in plan.get("groups", [])
            if g["signature"].split("|", 1)[-1] == signature]
        if not candidates:
            return None
        return any(not check_envelope(g, envelope, self.tolerances,
                                      where="") for g in candidates)
