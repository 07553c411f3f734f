"""The chunk kernel against the per-tick path on a plan-shaped K > 1 sweep,
µs per tick (``benchmarks/kernel_sweep.py``).

The reference times its fused Pallas CC-tick kernel against its jnp
oracle, both through `run_plan`.  The port has no kernel switch; its two
modes are:

* "fused": the chunk kernel (``kernels/csrc/netsim_chunk.cu``, one launch
  per chunk of ticks), through `common.run_plan`;
* "oracle": the chunk kernel's plain version, the per-tick path
  (`engine.run_ticks(cfg, sweep, per_tick=True)`: torch ops per tick, the
  CC update through the per-tick kernel ``mltcp_step.cu``), on the plan's
  one group.  It is not a plan run, so it adds nothing to the suite's
  health.

On the card the per-tick path runs as a CUDA graph of one chunk
(`netsim.tick_graph`), the port's counterpart of the reference's compiled
oracle, so both modes run the same plan at the suite's own simulated time
(``SIM_TIME``), as the reference's do.  Each mode runs a warm-up, then the
timed run.  ``interpret`` is true where the runs did not take the card
(the CPU, where both modes run the plain version).
"""
from __future__ import annotations

import time

from repro_torch import device as device_mod
from repro_torch import netsim
from repro_torch.figures import common
from repro_torch.netsim import counters, engine, experiment, metrics

def _plan(use_kernel: bool, job_counts) -> netsim.Plan:
    def build(pt):
        n = pt["n_jobs"]
        return common.build_cfg(netsim.dumbbell(n, sockets_per_job=2),
                                common.gpt2(n),
                                common.protocol("reno", "WI"))
    return common.plan(build, name=f"kernel-sweep-{use_kernel}",
                       n_jobs=tuple(job_counts),
                       seed=common.seed_axis())


def make_plan(use_kernel: bool = True, job_counts=(2, 3)) -> netsim.Plan:
    """The fused mode's plan (the oracle's with ``use_kernel=False``): the
    job counts pad into one group.  ``python -m repro_torch.analysis --plan
    kernel_sweep`` lints it: the static form of the suite's
    ``kernel_fallbacks == 0``."""
    return _plan(use_kernel, job_counts)


def _per_tick(plan: netsim.Plan, device=None) -> netsim.PlanResult:
    """The plan's one group on the per-tick path, as a PlanResult."""
    points, cfgs, overrides, groups = experiment.resolve_plan(plan)
    (group,) = groups
    sweep = experiment.group_sweep(cfgs, overrides, group, device=device)
    with counters.watch() as w:
        raw = engine.run_ticks(group.cfg, sweep, per_tick=True)
    # to the host in one copy a leaf, as run_plan moves a group's outputs
    raw = engine.tree_map(lambda x: x.cpu(), raw._replace(final_state=None))
    results = [metrics.postprocess(cfgs[i], engine.point_of(raw, slot),
                                   n_jobs=cfgs[i].jobs.n_jobs)
               for slot, i in enumerate(group.idxs)]
    return netsim.PlanResult(plan=plan, results=results, n_compile_groups=1,
                             n_kernel_fallbacks=w.fallbacks)


def _timed_plan(use_kernel: bool, job_counts, device=None
                ) -> tuple[float, int, int]:
    """(steady-state seconds, total ticks, kernel fallbacks) for one mode.

    Fallbacks are read off the warm-up run, as the reference reads them."""
    plan = _plan(use_kernel, job_counts)
    run_mode = common.run_plan if use_kernel else _per_tick
    warmup = run_mode(plan, device=device)
    t0 = time.time()
    pr = run_mode(plan, device=device)
    wall = time.time() - t0
    return wall, pr.n_ticks, warmup.n_kernel_fallbacks


def run(job_counts=(2, 3), device=None) -> tuple[dict, int]:
    oracle_s, n_ticks, _ = _timed_plan(False, job_counts, device)
    fused_s, fused_ticks, fallbacks = _timed_plan(True, job_counts, device)
    if fallbacks != 0:
        raise AssertionError(
            f"the fused mode fell back to the per-tick path {fallbacks} "
            f"times — the sweep did not run on the chunk kernel")
    oracle_us = 1e6 * oracle_s / max(n_ticks, 1)
    fused_us = 1e6 * fused_s / max(fused_ticks, 1)
    out = {
        "oracle_us_per_tick": round(oracle_us, 3),
        "fused_us_per_tick": round(fused_us, 3),
        "fused_over_oracle": round(fused_us / max(oracle_us, 1e-9), 3),
        "kernel_fallbacks": fallbacks,
        "interpret": device_mod.resolve(device).type != "cuda",
    }
    # each mode ran its plan twice (warm-up + timed): report all the ticks
    # simulated so the harness's µs/tick stays honest
    return out, 2 * (n_ticks + fused_ticks)


if __name__ == "__main__":
    import json
    derived, _ = run()
    common.merge_results({"kernel_sweep": derived})
    print(json.dumps(derived, indent=1))
