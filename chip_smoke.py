#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --probe KERNEL [OLD/KERNEL.cu ...]

It builds the port's four kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, all started together; sm_90a, into
``build/kernels/``) and drives these paths:

* the simulator: it holds the fused CC-tick kernel bit for bit against its
  plain PyTorch version for every specialization, holds the chunk kernel
  (a whole chunk of fabric ticks per launch) bit for bit against the
  per-tick path on every output leaf for each algorithm, variant and
  engine option at the paper's widths, and its armed specializations
  (every telemetry probe and detector, all four fault channels) on every
  leaf, the telemetry state's included, drives the simulator's main path
  through the chunk kernel at full width (the paper's Fig. 7-9 convergence
  setup: two GPT-2 jobs on a 50 Gbps dumbbell, Reno OFF and WI, a two-seed
  sweep each, the suite's 1.5 s of simulated time), checks the figure
  metrics, times both paths in turns, and feeds the CC kernel states taken
  from CUBIC and DCQCN runs of the engine;
* experiment plans: it runs the paper's fig 10 plans (Reno and DCQCN:
  OFF/WI x 2-6 jobs, two padded groups of K=5 each) and fig 12 plan
  (straggle probability x base/MLQCN/Cassini on DCQCN with ECN) through
  ``netsim.run_plan`` and the chunk kernel at the suites' 1.5 s, counts
  each plan's launches on its own, reports every cell beside the JAX
  reference's numbers for the same plans
  (``results/reference_plans.json``, written by
  ``scripts/reference_plans.py``), holds a padded-jobs point bit for bit
  against the same point run alone, serves the fig 12 plan a second time
  from the plan cache with no launch, and times one group as K grows
  from 2 to 264; fig 10 Reno runs at seeds 1-3, beside the reference's
  three seeds;
* telemetry and faults: the fig 5 timeline plan (benchmarks/timeline.py:
  Reno, CUBIC, DCQCN x OFF/WI x seeds 1-3 with the suite's probes and
  detectors) and the churn gauntlet (benchmarks/churn.py: three jobs on a
  100 Gbps dumbbell, churn, flaps and blackholes as a schedule axis)
  through ``run_plan`` and the armed chunk kernel, each counted, held to
  its suite's assertions and beside the reference's numbers; the
  sketch's ``logf`` against ``torch.log`` on every float32 in its range;
  fig7-reno armed and unarmed in turns;
* serving: it holds the RG-LRU scan kernel bit for bit (both of its
  routes: the serve shape, ragged and unaligned operands, T = 1) and the
  flash attention kernel within 2e-5 (f32) / 2e-2 (bf16 inputs) against
  their plain versions, times both beside their plain versions, the scan
  beside ``torch.add`` over the same bytes (its achievable-rate
  yardstick) and flash beside ``F.scaled_dot_product_attention`` under
  each backend that takes the serve case (the fastest is the flash row's
  ``library_ms``), then serves
  recurrentgemma-2b at its full published widths (batch 4, a 4096-token
  prompt, 16 new tokens, random weights from seed 0) through
  ``repro_torch.launch.serve`` and holds that prefill against the
  plain-path prefill of the same prompt.
* training: it holds both LM kernels' backward passes against autograd
  through their plain versions, bit for bit (the RG-LRU reverse scan on
  the training shape, bf16, ragged and unaligned operands, T = 1, h0;
  flash's recomputed dense VJP, with the flash forward of the same cases,
  the training shape among them, within its tolerance), holds the loss
  and gradients of recurrentgemma-2b at full width cut to one group of
  its pattern (T = 4096) on the kernel path against the plain path,
  trains the full 26-block model eight steps of 1 x 4096 tokens through
  ``repro_torch.launch.train`` (f32 parameters and AdamW moments, remat),
  counting 16 flash and 52 RG-LRU launches a step and no plain-path call,
  reports the first step and the spread of steps 2-7, profiles one warm
  step, and resumes a smoke-preset run from a checkpoint;
* the other model families: deepseek-moe-16b (MoE; batch 1), xlstm-125m
  (mLSTM/sLSTM; batch 4) and seamless-m4t-medium (encoder-decoder; batch
  4 over 1024 frames), each at its full published widths and depth with
  random weights from seed 0, served through ``repro_torch.launch.serve``
  (a 4096-token prompt, 16 new tokens), counting 28, 0 and 24 flash
  launches a prefill, with the warm prefill held against the plain-path
  prefill (and, for the MoE, every routing choice of the two compared,
  flips reported with their margins); a profiled prefill, warm decode,
  and the MoE dispatch's and the xLSTM blocks' own times;
* the shared-cluster driver: ``repro_torch.cluster.simulate_shared_cluster``
  at the defaults of ``examples/simulate_cluster.py`` (two qwen3-1.7b jobs
  and an olmo-1b job, DCQCN, default against MLTCP, 4 s), then a mix with
  a MoE job (deepseek-moe-16b's two-burst dp+ep profile beside two
  qwen3-1.7b jobs), each through ``run_plan`` and the chunk kernel.

``--probe KERNEL`` (``flash_attention`` or ``rg_lru``; ``--probe-flash``
is ``--probe flash_attention``) is the short first call after a change to
that kernel: it builds the kernels (``ptxas -v``), holds the checkout's
kernel and each given source of it (an earlier version, a variant) to the
plain version on the kernel's checks (``FLASH_CASES`` and the serve case;
the RG-LRU cases, bit for bit), times the serve case back to back in turns
(the given sources, the checkout twice, the given sources in reverse) and
stops.

Each phase prints one JSON line; any failure raises and the exit code is
non-zero.  The last lines are the kernel table, the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}``.  Nothing here
imports JAX or the reference package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense
DT = 2e-5
RTT = 100e-6
WORK_SCALE = 0.25                  # benchmarks/common.py (not REPRO_FULL)
# Depth of the main path: the suite's REPRO_SMOKE depth, 1.5 s (75,000
# ticks), through the chunk kernel; widths, jobs and protocol settings are
# the suite's.  The per-tick path (~2-3 ms a tick on the card's host) is
# timed beside it at PER_TICK_SIM_TIME.
MAIN_SIM_TIME = 1.5
PER_TICK_SIM_TIME = 0.04
# fig7-reno's figure numbers at 1.5 s through the per-tick path, as
# PERF.md §6 records them: the chunk kernel, bitwise equal to that path,
# prints them beside its own
PER_TICK_FIG7 = dict(OFF_interleave=0.7506, WI_interleave=0.2101,
                 avg_speedup=1.138, p99_speedup=1.117)
SPEC_SIM_TIME = 0.15
AGREE_SIM_TIME = 0.06
# depth and workload scale of each chunk-vs-per-tick case (the per-tick
# side sets its cost)
CHUNK_CASE_SIM_TIME = 0.06
CHUNK_CASE_SCALE = 0.25
# depth of the armed kernel's cases (telemetry and faults armed: the
# per-tick side costs more a tick)
ARMED_CASE_SIM_TIME = 0.03
SEEDS = (1, 2)
# paper §4.1 (slope, intercept) and RED/ECN thresholds, benchmarks/common.py
PARAMS = {"reno": (1.75, 0.25), "cubic": (1.0, 0.5), "dcqcn": (1.067, 0.267)}
RED_BY_ALGO = {
    "reno": dict(red_qmin=150e3, red_qmax=1.5e6, red_pmax=0.12),
    "cubic": dict(red_qmin=150e3, red_qmax=1.5e6, red_pmax=0.12),
    "dcqcn": dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2),
}
ALGO_ID = {"reno": 0, "cubic": 1, "dcqcn": 2}
# arithmetic ops per flow of one kernel specialization, counted from the
# source (the cube root's four Newton steps dominate CUBIC)
OPS_PER_FLOW = {0: 30, 1: 70, 2: 45}
REPLACES = "src/repro/kernels/mltcp_step.py:98"
DEVICE = "cuda"
# Latency model of one tick of the chunk kernel (PERF.md §6): cycles of
# one dependent shared-memory load and use and of one CTA barrier (assumed
# Hopper figures, not measured here); the clock is the card's own
# (`sm_clock_hz`).
SMEM_LATENCY_CYCLES = 30
BARRIER_CYCLES = 20
# The unarmed chunk kernel's fig7-reno specialization (Reno WI, job
# statistics, no factors): its registers as PERF.md §6 row 1 records them;
# arming telemetry and faults must leave its code as it was.
UNARMED_FIG7_REGISTERS = 117

RESULTS: dict = {}


def emit(phase: str, **fields) -> None:
    RESULTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_rows(prof) -> list:
    """The profiler's device-side rows (kernels, copies, fills): the
    host-side ops that launched them carry the same time again."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: the summed duration of the kernels
    it runs, from the profiler's CUPTI trace (host time excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(_device_us(e) for e in device_rows(prof))
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy_us * 1e-3 / reps


def event_ms(fn, reps: int, warm: int = 3) -> float:
    """Median over ``reps`` calls of the CUDA-event time of one call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` run ``reps`` times back to back, by CUDA
    events around the whole run: the card's time per call when the host
    queues calls faster than the card runs them (the LM kernels and the
    dense attention), the host's otherwise (the plain RG-LRU loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel operands
# ---------------------------------------------------------------------------

def fuzz_operands(ms, core, algo, variant, aggregate, factors, k, n, gen):
    """Random mid-run operands on the card, in the ranges the CPU tests
    fuzz (tests/_torch_reference.py)."""
    import torch

    dev = torch.device(DEVICE)

    def u(lo, hi):
        return torch.rand((k, n), generator=gen, device=dev) * (hi - lo) + lo

    arrays = dict(
        bytes_sent=u(0, 1e8), prev_ack_tstamp=u(0, 0.01),
        iter_gap=u(1e-3, 0.05), max_gap=u(1e-3, 0.05),
        cwnd=u(1, 500), ssthresh=u(10, 1e4), cooldown=u(0, 2e-4),
        w_max=u(1, 500), epoch_start=u(0, 0.01), rate_cur=u(1e6, 6e9),
        rate_target=u(1e6, 6e9), alpha=u(0, 1), t_last_cnp=u(0, 0.01),
        t_last_inc=u(0, 0.01), t_last_alpha=u(0, 0.01),
        stage=torch.randint(0, 10, (k, n), generator=gen, device=dev,
                            dtype=torch.int32),
        prev_ratio=u(0, 1),
        num_acks=torch.where(u(0, 1) < 0.7, u(0, 40), 0.0),
        loss=u(0, 1) < 0.2, cnp=u(0, 1) < 0.3, total_bytes=u(1e7, 2e8))
    arrays["ack_bytes"] = arrays["num_acks"] * 1500.0
    if aggregate:
        arrays["job_numer"] = u(0, 2e8)
    dyn = torch.stack([u(0.5, 2.0)[:, 0], u(0.1, 0.5)[:, 0],
                       u(0.6, 0.9)[:, 0], u(0.3, 0.7)[:, 0],
                       u(5e-4, 3e-3)[:, 0]], dim=-1).contiguous()
    now = u(0.01, 0.02)[:, 0].contiguous()
    fac = torch.where(u(0, 1) < 0.5, u(0.25, 2.0), -1.0) if factors else None
    p = ms.static_params(core.CCParams(algo=algo, variant=variant), aggregate)
    return p, dyn, arrays, now, fac


def compare_outputs(ms, got: dict, want: dict) -> float:
    """Raise unless every output is bitwise equal; return max |diff|."""
    import torch

    worst = 0.0
    for name in ms.OUT_ORDER:
        g, w = got[name], want[name]
        if g.dtype == torch.float32:
            worst = max(worst, float((g - w).abs().max()))
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(f"kernel != plain version on {name!r}")
    return worst


def operand_bytes(ms, p, dyn, arrays, now, fac) -> int:
    """Bytes the function must move: each input once, each output once."""
    k, n = arrays["cwnd"].shape
    names = ms.IN_ORDER if p["aggregate"] else ms.IN_ORDER[:-1]
    read = sum(arrays[f].element_size() * arrays[f].numel() for f in names)
    read += dyn.numel() * 4 + now.numel() * 4
    if fac is not None:
        read += fac.numel() * 4
    write = (len(ms.OUT_ORDER) * 4) * k * n
    return read + write


def bound_ms(ms, p, dyn, arrays, now, fac) -> tuple[float, str]:
    k, n = arrays["cwnd"].shape
    t_bytes = operand_bytes(ms, p, dyn, arrays, now, fac) / HBM_BYTES_PER_S
    t_ops = OPS_PER_FLOW[p["algo"]] * k * n / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(libraries) -> dict:
    import torch

    t0 = time.time()
    procs = [lib.start_build() for lib in libraries]  # one nvcc per source
    for lib, proc in zip(libraries, procs):
        lib.finish_build(proc)
    build_s = time.time() - t0
    regs = {lib.name: sorted({line.split("Used")[1].split(",")[0].strip()
                              for line in lib.build_log.splitlines()
                              if "Used" in line})
            for lib in libraries}
    spills = {lib.name: sorted({line.strip() for line in
                                lib.build_log.splitlines()
                                if "spill" in line and " 0 bytes spill s"
                                not in line})
              for lib in libraries}
    info = dict(name=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), nvidia_smi=nvidia_smi(),
                torch=torch.__version__, cuda=torch.version.cuda,
                build_s=round(build_s, 3), built=[bool(p) for p in procs],
                ptxas_registers=regs, ptxas_spills=spills)
    emit("device", **info)
    return info


def phase_kernel(ms, core) -> dict:
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    n_specs, worst = 0, 0.0
    for algo in (0, 1, 2):
        for variant in (0, 1, 2, 3):
            for aggregate in (False, True):
                for factors in (False, True):
                    ops = fuzz_operands(ms, core, algo, variant, aggregate,
                                        factors, 4, 1000, gen)
                    worst = max(worst, compare_outputs(
                        ms, ms.mltcp_tick(*ops),
                        ms.mltcp_tick_reference(*ops)))
                    n_specs += 1
    torch.cuda.synchronize()

    def timed(algo, k, n, reps, plain_reps):
        ops = fuzz_operands(ms, core, algo, 1, True, False, k, n, gen)
        err = compare_outputs(ms, ms.mltcp_tick(*ops),
                              ms.mltcp_tick_reference(*ops))
        b_ms, b_by = bound_ms(ms, *ops)
        kernel = lambda: ms.mltcp_tick(*ops)                    # noqa: E731
        plain = lambda: ms.mltcp_tick_reference(*ops)           # noqa: E731
        return dict(algo=algo, k=k, n=n, max_abs_err=err,
                    ms=event_ms(kernel, reps),
                    plain_ms=event_ms(plain, plain_reps),
                    device_ms=device_ms(kernel, reps),
                    plain_device_ms=device_ms(plain, plain_reps),
                    bound_ms=b_ms, bound_by=b_by,
                    bytes=operand_bytes(ms, *ops))

    # the main path's shape (K=2 seeds x N=4 flows) and a bandwidth shape
    main_shape = [timed(a, 2, 4, 200, 50) for a in (0, 1, 2)]
    large = [timed(a, 64, 16384, 50, 10) for a in (0, 1, 2)]
    for row in large:
        row["gbytes_per_s"] = row["bytes"] / (row["device_ms"] * 1e-3) / 1e9
    out = dict(specializations=n_specs, shape=[4, 1000], bitwise=True,
               max_abs_err=worst, main_shape=main_shape, large=large)
    emit("kernel_vs_plain", **out)
    return out


def fig7_cfg(core, netsim, workload, algo: str, variant: int,
             sim_time: float, topo=None, models=("gpt2", "gpt2"),
             proto_kw=None, scale=1.0, **cfg_kw):
    """benchmarks/common.build_cfg for two GPT-2 jobs on dumbbell(2, 2)
    (another fabric, job mix, workload scale, protocol option or engine
    option on request)."""
    slope, intercept = PARAMS[algo]
    proto = core.MLTCPConfig(
        cc=core.CCParams(algo=ALGO_ID[algo], variant=variant, tick_dt=DT,
                         rtt=RTT),
        slope=slope, intercept=intercept, **(proto_kw or {}))
    profiles = [workload.profile_for(m).scaled(WORK_SCALE * scale)
                for m in models]
    return netsim.SimConfig(
        topo=topo or netsim.dumbbell(2, sockets_per_job=2),
        jobs=workload.jobspec_from_profiles(profiles), protocol=proto,
        sim_time=sim_time, dt=DT, seed=SEEDS[0],
        **{**RED_BY_ALGO[algo], **cfg_kw})


def ticks_run(cfg) -> int:
    per_chunk = max(1, cfg.n_ticks // cfg.n_chunks)
    return (cfg.n_ticks // per_chunk) * per_chunk


def n_chunks_run(cfg) -> int:
    return cfg.n_ticks // max(1, cfg.n_ticks // cfg.n_chunks)


def counted(kern, fn):
    """``fn()`` with every launch and fallback count set to 0 just before
    and read just after, timed on the host clock around a synchronized
    run; returns (fn's result, seconds, counts)."""
    import torch

    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    torch.cuda.synchronize()
    ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = dict(netsim_chunk=nc.LAUNCH_COUNT, mltcp_step=ms.LAUNCH_COUNT,
                  fallbacks=ops.FALLBACK_COUNT,
                  chunk_fallbacks=ops.CHUNK_FALLBACK_COUNT)
    return out, seconds, counts


def run_counted(kern, cfg, sweep=None, per_tick=False):
    """One sweep, `counted`; returns (raw, seconds, counts).
    ``per_tick`` runs the per-tick path (the chunk kernel's plain version)
    instead of the main path."""
    from repro_torch import netsim
    from repro_torch.netsim import engine

    if sweep is None:
        sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
    if per_tick:
        return counted(kern, lambda: engine.run_ticks(cfg, sweep,
                                                      per_tick=True))
    return counted(kern, lambda: netsim.simulate_sweep(cfg, sweep,
                                                       device=DEVICE))


def check_counts(what: str, cfg, counts: dict, per_tick=False) -> None:
    """The main path: one chunk launch per chunk, no per-tick CC launch,
    no fallback; the per-tick path: one CC launch per tick, no chunk."""
    want = dict(netsim_chunk=0 if per_tick else n_chunks_run(cfg),
                mltcp_step=ticks_run(cfg) if per_tick else 0,
                fallbacks=0, chunk_fallbacks=0)
    if counts != want:
        raise AssertionError(f"{what}: launches and fallbacks {counts}, "
                             f"expected {want}")


def check_finite(netsim, cfg, raw) -> list:
    import numpy as np

    res = netsim.postprocess_sweep(cfg, raw)
    for r in res:
        if any(x.size == 0 or not np.all(np.isfinite(x))
               for x in r.iter_times):
            raise AssertionError("a job recorded no finite iteration")
        if not np.all(np.isfinite(r.trace_util)):
            raise AssertionError("non-finite link utilization")
    if tuple(raw.trace_incomm.shape[:1]) != (len(SEEDS),):
        raise AssertionError(f"unexpected shape {tuple(raw.trace_incomm.shape)}")
    return res


def named_leaves(tree, prefix="") -> list:
    """(name, leaf) for every tensor or array of a NamedTuple tree."""
    import numpy as np
    import torch

    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):          # a TelemetryState's probe rings
        names, tree = list(tree), list(tree.values())
    else:
        names = getattr(tree, "_fields", None) or range(len(tree))
    return [x for name, v in zip(names, tree)
            for x in named_leaves(v, f"{prefix}.{name}" if prefix else
                                  str(name))]


def compare_trees(got, want, what="chunk kernel != per-tick path"
                  ) -> tuple[float, int]:
    """Raise (``what`` and the leaf) unless every leaf is bitwise equal
    (NaNs included); returns (max |diff| over the float leaves, the number
    of leaves)."""
    import numpy as np
    import torch

    a, b = named_leaves(got), named_leaves(want)
    if [n for n, _ in a] != [n for n, _ in b]:
        raise AssertionError("the two outputs have different leaves")
    worst = 0.0
    for (name, g), (_, w) in zip(a, b):
        if isinstance(g, np.ndarray):
            same = np.array_equal(g, w)
        elif g.dtype != w.dtype or g.shape != w.shape:
            same = False
        elif g.dtype == torch.float32:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
            both = torch.isnan(g) & torch.isnan(w)
            diff = torch.where(both, 0.0, (g - w).abs())
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"{what} on {name}")
    return worst, len(a)


def chunk_cases(core, netsim, workload, sim_time: float) -> list:
    """(name, config, sweep overrides) of the chunk-vs-per-tick check: Reno
    OFF/WI/MD, CUBIC, DCQCN with ECN, Static factors, per-flow statistics,
    Cassini with stragglers at the fig 7 width (K=2, N=4); the fig 10
    width (6 jobs x 2 flows, padded to 2-6 active jobs, K=5); the two-tier
    leaf/spine (M=9) with a 4-phase GPT-3 hybrid job.  The workload is
    scaled to a quarter of the suite's (iterations of ~12 ms, not ~45 ms)
    so that a short case completes iterations; the widths are the
    suite's."""
    import numpy as np

    def cfg(algo, variant, **kw):
        return fig7_cfg(core, netsim, workload, algo, variant, sim_time,
                        scale=CHUNK_CASE_SCALE, **kw)
    seeds = dict(seed=list(SEEDS))
    return [
        ("reno_off", cfg("reno", 0), seeds),
        ("reno_wi", cfg("reno", 1), seeds),
        ("reno_md", cfg("reno", 2), seeds),
        ("cubic_wi", cfg("cubic", 1), seeds),
        ("dcqcn_wi_ecn", cfg("dcqcn", 1), seeds),
        ("reno_wi_static_factors",
         cfg("reno", 1, static_job_factors=np.asarray([0.6, -1.0])), seeds),
        ("reno_wi_per_flow_stats",
         cfg("reno", 1, proto_kw=dict(aggregate_by_job=False)), seeds),
        ("reno_wi_cassini_stragglers",
         cfg("reno", 1, cassini=netsim.CassiniSchedule(
             offset=np.asarray([0.0, 0.006]), period=np.asarray([0.013, 0.0]),
             eps=1e-3)),
         dict(seed=list(SEEDS), straggle_prob=[[0.5, 0.5], [0.2, 0.0]])),
        ("fig10_width_padded",
         cfg("reno", 1, topo=netsim.dumbbell(6, sockets_per_job=2),
             models=("gpt2",) * 6),
         dict(seed=[SEEDS[0]] * 5,
              job_active=[[j < n for j in range(6)] for n in range(2, 7)])),
        ("two_tier",
         cfg("cubic", 1, topo=netsim.two_tier([(0, 1), (1, 2), (2, 3), (3, 0)],
                                             sockets_per_job=2),
             models=("gpt3_hybrid", "gpt2", "gpt2", "gpt2")), seeds),
    ]


def armed_cases(core, netsim, workload, sim_time: float) -> list:
    """(name, config, sweep overrides) of the armed kernel's check.  Every
    algorithm (WI) at the fig 7 width (2 jobs) and at 3 jobs, with every
    built-in probe, the three detectors and all four fault channels; point
    0 under a schedule that departs and re-admits the last job, flaps the
    bottleneck, blackholes flow 0 and bursts the straggle probability,
    point 1 under the identity schedule.  Then the specializations the two
    plan phases run, at their widths (`SUITE_SOCKETS`: DCQCN one socket a
    job), OFF and WI: the fig 5 plan's (telemetry alone, `fig5_spec`) and
    the churn gauntlet's (`churn_spec` and its fault spec on the 100 Gbps
    3-job dumbbell, point 0 under the gauntlet schedule, point 1 under the
    staggered one)."""
    import numpy as np

    from repro_torch.netsim import telemetry

    spec = netsim.TelemetrySpec(probes=telemetry.BUILTIN_PROBES, stride=7,
                                detectors=telemetry.DETECTORS)
    faults = netsim.FaultSpec(n_events=10, churn=True, link_flaps=True,
                              blackholes=True, straggle_bursts=True)
    out = []
    for algo in ("reno", "cubic", "dcqcn"):
        for n_jobs in (2, 3):
            cfg = fig7_cfg(core, netsim, workload, algo, 1, sim_time,
                           topo=netsim.dumbbell(n_jobs, sockets_per_job=2),
                           models=("gpt2",) * n_jobs, scale=CHUNK_CASE_SCALE,
                           telemetry=spec, faults=faults)
            t = sim_time
            sched = netsim.fault_schedule(cfg, [
                netsim.job_departs(0.2 * t, n_jobs - 1),
                netsim.job_arrives(0.45 * t, n_jobs - 1),
                netsim.link_flap(0.3 * t, 0.6 * t, 0, 0.5),
                netsim.blackhole(0.1 * t, 0.35 * t, [0]),
                netsim.straggle_burst(0.05 * t, 0.7 * t, 0.5)], spec=faults)
            ident = netsim.identity_schedule(cfg, faults)
            out.append((f"{algo}_wi_armed_{n_jobs}jobs", cfg, dict(
                seed=list(SEEDS),
                **{f: np.stack([sched.values[f], ident.values[f]])
                   for f in sched.values})))
    churn_faults = netsim.FaultSpec(n_events=8, churn=True, link_flaps=True,
                                    blackholes=True)
    for algo, sockets in SUITE_SOCKETS.items():
        for variant in VARIANT:
            cfg = fig7_cfg(core, netsim, workload, algo, VARIANT[variant],
                           sim_time, topo=netsim.dumbbell(
                               2, sockets_per_job=sockets),
                           scale=CHUNK_CASE_SCALE,
                           telemetry=fig5_spec(netsim))
            out.append((f"{algo}_{variant.lower()}_fig5", cfg,
                        dict(seed=list(SEEDS))))
            cfg = fig7_cfg(core, netsim, workload, algo, VARIANT[variant],
                           sim_time, topo=netsim.dumbbell(
                               CHURN_JOBS, sockets_per_job=sockets,
                               cap_gbps=CHURN_CAP_GBPS),
                           models=("gpt2",) * CHURN_JOBS,
                           scale=CHUNK_CASE_SCALE, telemetry=churn_spec(netsim),
                           faults=churn_faults)
            scheds = [netsim.fault_schedule(
                cfg, churn_events(netsim, cfg, label), spec=churn_faults)
                for label in CHURN_SCHEDULES]
            out.append((f"{algo}_{variant.lower()}_churn", cfg, dict(
                seed=list(SEEDS),
                **{f: np.stack([sc.values[f] for sc in scheds])
                   for f in scheds[0].values})))
    return out


def phase_chunk_vs_per_tick(kern, core, netsim, workload) -> dict:
    """The chunk kernel against the per-tick path (its plain version, with
    the per-tick CC kernel) on the card: every leaf of RawSimOutput,
    final_state and telemetry included, bit for bit; the unarmed kernel on
    the engine options, the armed one on `armed_cases`."""
    out = {}
    sim_time = CHUNK_CASE_SIM_TIME
    cases = (chunk_cases(core, netsim, workload, sim_time)
             + armed_cases(core, netsim, workload, ARMED_CASE_SIM_TIME))
    for name, cfg, overrides in cases:
        sweep = netsim.make_sweep(cfg, device=DEVICE, **overrides)
        got, chunk_s, counts = run_counted(kern, cfg, sweep)
        check_counts(name, cfg, counts)
        want, tick_s, tick_counts = run_counted(kern, cfg, sweep,
                                                per_tick=True)
        check_counts(f"{name} per-tick", cfg, tick_counts, per_tick=True)
        err, n_leaves = compare_trees(got, want)
        ticks = ticks_run(cfg)
        if int(want.iter_counts.sum()) == 0:
            raise AssertionError(f"{name}: no iteration completed, so the "
                                 f"comparison misses the phase machine")
        out[name] = dict(
            k=int(sweep.slope.shape[0]), m=cfg.topo.n_links,
            n=cfg.topo.n_flows, j=cfg.jobs.n_jobs, ticks=ticks,
            armed=kern["nc"].armed_bits(cfg),
            chunks=n_chunks_run(cfg), leaves=n_leaves, bitwise=True,
            max_abs_err=err,
            iterations=int(want.iter_counts.sum()),
            boundaries=int(want.final_state.proto.det.n_boundaries.sum()),
            chunk_us_per_tick=1e6 * chunk_s / ticks,
            per_tick_us_per_tick=1e6 * tick_s / ticks)
    emit("chunk_vs_per_tick", sim_time=sim_time,
         armed_sim_time=ARMED_CASE_SIM_TIME, cases=out)
    return out


def host_inputs(cfg, n: int = 20, seeds=SEEDS, numpy_draws=True) -> dict:
    """The host's share of a chunk apart, each in µs per tick at the
    config's chunk size for a sweep over ``seeds``: `chunk_inputs` (the
    library's C draws into pinned memory, the copy, the time and start
    masks), the C draws alone, and (``numpy_draws``) the numpy draws
    (`netsim.random.chunk_draws`, the CPU path) alone."""
    import torch

    from repro_torch import netsim
    from repro_torch.kernels import netsim_chunk as nc
    from repro_torch.netsim import engine
    from repro_torch.netsim import random as rng

    sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(seeds))
    statics = engine._build_statics(cfg, sweep.slope.device)
    st = engine._init_state(cfg, statics, sweep)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    engine.chunk_inputs(cfg, statics, sweep, st, tpc)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        inputs = engine.chunk_inputs(cfg, statics, sweep, st, tpc)
        st = st._replace(key=inputs.key[-1])
    torch.cuda.synchronize()
    t1 = time.time()
    key = st.key
    n_flows, n_jobs = cfg.topo.n_flows, cfg.jobs.n_jobs
    out = torch.empty((tpc, len(seeds), 2 * n_flows + 2 * n_jobs))
    for _ in range(n):
        key = nc.host_draws(key, tpc, n_flows, n_jobs, out)[-1]
    t2 = time.time()
    out = dict(ticks_per_chunk=tpc,
               chunk_inputs_us_per_tick=1e6 * (t1 - t0) / (n * tpc),
               c_draws_us_per_tick=1e6 * (t2 - t1) / (n * tpc))
    if numpy_draws:
        for _ in range(n):
            key = rng.chunk_draws(key, tpc, n_flows, n_jobs).keys[-1]
        out["numpy_draws_us_per_tick"] = 1e6 * (time.time() - t2) / (n * tpc)
    return out


def phase_main_path(kern, core, netsim, workload) -> dict:
    """fig7-reno OFF and WI at the suite's 1.5 s through the chunk kernel,
    counted; then both paths timed in turns on the WI sweep."""
    import numpy as np

    runs, cc_launches = {}, 0
    for name, variant in (("OFF", 0), ("WI", 1)):
        cfg = fig7_cfg(core, netsim, workload, "reno", variant, MAIN_SIM_TIME)
        raw, seconds, counts = run_counted(kern, cfg)
        check_counts(f"main path {name}", cfg, counts)
        cc_launches += counts["mltcp_step"]
        ticks = ticks_run(cfg)
        res = check_finite(netsim, cfg, raw)
        runs[name] = dict(
            results=res, ticks=ticks, chunks=n_chunks_run(cfg),
            seconds=seconds, launches=counts["netsim_chunk"],
            us_per_tick=1e6 * seconds / ticks,
            interleave=float(np.mean([netsim.mean_pairwise_interleave(r)
                                      for r in res])),
            iter_counts=[[len(x) for x in r.iter_times] for r in res],
            drops_per_s=float(np.mean([r.drops_per_s for r in res])))
    off, wi = runs["OFF"], runs["WI"]
    if not wi["interleave"] < off["interleave"]:
        raise AssertionError(f"WI interleave {wi['interleave']} is not "
                             f"below OFF's {off['interleave']}")
    sp = netsim.sweep_speedup_stats(off["results"], wi["results"])

    # both paths in turns on the WI sweep: per-tick (short), chunk, chunk,
    # per-tick
    turns = []
    per_tick_path_launches = None
    for per_tick in (True, False, False, True):
        cfg = fig7_cfg(core, netsim, workload, "reno", 1,
                       PER_TICK_SIM_TIME if per_tick else MAIN_SIM_TIME)
        _, seconds, counts = run_counted(kern, cfg, per_tick=per_tick)
        check_counts("turn", cfg, counts, per_tick=per_tick)
        if per_tick and per_tick_path_launches is None:
            per_tick_path_launches = counts["mltcp_step"]
        turns.append(dict(path="per_tick" if per_tick else "chunk",
                          ticks=ticks_run(cfg), seconds=seconds,
                          us_per_tick=1e6 * seconds / ticks_run(cfg)))
    chunk_us = statistics.median(t["us_per_tick"] for t in turns
                                 if t["path"] == "chunk")
    tick_us = statistics.median(t["us_per_tick"] for t in turns
                                if t["path"] == "per_tick")
    cpu_era = None
    path = os.path.join(ROOT, "results", "benchmarks.json")
    if os.path.exists(path):
        with open(path) as f:
            fig = json.load(f).get("fig7_9_convergence", {}).get("reno")
        if fig is not None:
            cpu_era = {"source": "results/benchmarks.json (JAX reference, "
                                 "CPU, REPRO_SMOKE)",
                       **{k: fig[k] for k in ("baseline_interleave",
                                              "mltcp_interleave",
                                              "avg_speedup", "p99_speedup")}}
    out = dict(
        config="fig7-9 reno: 2x gpt2 @ WORK_SCALE 0.25, dumbbell(2, 2) "
               "50 Gbps, dt 2e-5, rtt 1e-4, seeds (1, 2)",
        sim_time=MAIN_SIM_TIME, launches=off["launches"] + wi["launches"],
        per_tick_cc_launches=cc_launches, fallbacks=0, chunk_fallbacks=0,
        **{f"{v}_{k}": runs[v][k] for v in ("OFF", "WI")
           for k in ("ticks", "chunks", "seconds", "us_per_tick",
                     "interleave", "iter_counts", "drops_per_s",
                     "launches")},
        avg_speedup=sp["avg_speedup"], p99_speedup=sp["p99_speedup"],
        per_tick_path_recorded=PER_TICK_FIG7,
        turns=turns, chunk_us_per_tick=chunk_us,
        per_tick_us_per_tick=tick_us, per_tick_over_chunk=tick_us / chunk_us,
        bar_met=bool(chunk_us <= 100.0 and tick_us / chunk_us >= 20.0),
        per_tick_path_launches=per_tick_path_launches,
        host=host_inputs(fig7_cfg(core, netsim, workload, "reno", 1,
                                  MAIN_SIM_TIME)),
        cpu_era=cpu_era)
    emit("main_path", **out)
    return out


def phase_small_agreement(core, netsim) -> dict:
    """The card's run against the CPU's (plain kernel path) on a small
    input: the Tier B tolerances of tests/test_torch_engine.py."""
    import numpy as np

    proto = core.MLTCPConfig(cc=core.CCParams(algo=0, variant=1, tick_dt=DT,
                                              rtt=RTT))
    cfg = netsim.SimConfig(
        topo=netsim.dumbbell(2, sockets_per_job=2),
        jobs=netsim.JobSpec.simple([0.0075] * 2, [25e6] * 2),
        protocol=proto, sim_time=AGREE_SIM_TIME, dt=DT, seed=3)
    gpu = netsim.postprocess(cfg, netsim.simulate(cfg, device=DEVICE))
    cpu = netsim.postprocess(cfg, netsim.simulate(cfg, device="cpu"))
    counts = ([len(x) for x in gpu.iter_times],
              [len(x) for x in cpu.iter_times])
    if min(counts[1]) < 1:
        raise AssertionError(f"no iteration finished on the CPU: {counts}")
    rel = [abs(float(np.mean(g)) / float(np.mean(c)) - 1.0)
           for g, c in zip(gpu.iter_times, cpu.iter_times)]
    if any(abs(a - b) > 1 for a, b in zip(*counts)) or max(rel) > 0.02:
        raise AssertionError(f"card vs CPU: counts {counts}, rel {rel}")
    out = dict(iter_counts_gpu=counts[0], iter_counts_cpu=counts[1],
               mean_iter_rel_diff=rel)
    emit("small_agreement", **out)
    return out


def phase_engine_states(kern, core, netsim, workload) -> dict:
    """CUBIC WI and DCQCN WI from the engine (the chunk kernel); their
    final protocol state and the feedback in the ring slot the next tick
    reads go through the per-tick CC kernel and its plain version."""
    import torch

    from repro_torch.core import iteration
    from repro_torch.netsim import engine

    ms = kern["ms"]
    out = {}
    for algo in ("cubic", "dcqcn"):
        cfg = fig7_cfg(core, netsim, workload, algo, 1, SPEC_SIM_TIME)
        raw, seconds, counts = run_counted(kern, cfg)
        check_counts(algo, cfg, counts)
        check_finite(netsim, cfg, raw)
        st = raw.final_state
        k = st.ring_ptr.shape[0]
        kidx = torch.arange(k, device=st.ring_ptr.device)
        ptr = st.ring_ptr.long()
        num_acks = st.ring_del[kidx, ptr] / cfg.protocol.cc.mss
        statics = engine._build_statics(cfg, st.tick.device)
        sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
        wl = engine._workload_view(cfg, statics, sweep)
        d, c = st.proto.det, st.proto.cc
        ackb = iteration.ack_bytes(num_acks, cfg.protocol.cc.mss)
        g = statics.groups
        arrays = {f: getattr(d, f) for f in ms.DET_FIELDS}
        arrays.update({f: getattr(c, f) for f in ms.CC_FIELDS})
        arrays.update(stage=c.inc_stage, prev_ratio=d.bytes_ratio,
                      num_acks=num_acks, ack_bytes=ackb,
                      loss=st.ring_loss[kidx, ptr], cnp=st.ring_cnp[kidx, ptr],
                      total_bytes=wl.flow_total,
                      job_numer=g.spread(g.sum(d.bytes_sent + ackb)))
        arrays = {f: v.contiguous() for f, v in arrays.items()}
        now = st.tick.to(torch.float32) * cfg.dt
        args = (ms.static_params(cfg.protocol.cc, True), wl.dyn.stacked(),
                arrays, now, None)
        err = compare_outputs(ms, ms.mltcp_tick(*args),
                              ms.mltcp_tick_reference(*args))
        out[algo] = dict(ticks=ticks_run(cfg), launches=counts,
                         us_per_tick=1e6 * seconds / ticks_run(cfg),
                         bitwise=True, max_abs_err=err)
    emit("engine_states", **out)
    return out


def chunk_bound(nc, cfg, st, after, run, inputs, traces) -> dict:
    """The least time one chunk launch from state ``st`` could take (``after``
    the plain version's state after it): the larger of the bytes the launch
    must move over the card's memory rate, the float operations over the
    f32 peak (counted from the source per tick), and the latency of a
    tick's dependent chain over the chunk's ticks (the model's cycles at
    the card's clock).  The bytes: the state read once and written once,
    but the accumulators (written only) and ``iter_times``, of which only
    the slots of this chunk's completed iterations are written; the run's
    constants, the chunk's inputs and the probes' trace column."""
    cs = nc.pack_state(st)
    state = sum(t.numel() * t.element_size() for name, t in
                zip(cs._fields, cs)
                if t is not None and name not in ("iter_times", "acc"))
    slots = int((after.iter_idx - st.iter_idx).sum())
    const = sum(t.numel() * t.element_size() for t in run[:7]
                if t is not None)
    ins = sum(t.numel() * t.element_size()
              for t in (inputs.t, inputs.started, inputs.loss_u,
                        inputs.cnp_u, inputs.straggles, inputs.strag_amt))
    out = sum(t.numel() * t.element_size() for t in traces)
    nbytes = (2 * state + cs.acc.numel() * cs.acc.element_size()
              + 4 * slots + const + ins + out)
    shape = nc.shape_of(cfg)
    m, n, j, s = shape["M"], shape["N"], shape["J"], shape["S"]
    k, ticks = int(inputs.t.shape[1]), int(inputs.t.shape[0])
    # per tick and point: 8 per (link, flow) element (enqueue, RED,
    # serve, route), the folds, the CC update and the per-flow phases, the
    # per-job phase machine and member folds
    ops = ((m + 1) * n * 8 + m * (2 * n + 12) + n * (25 + m)
           + n * OPS_PER_FLOW[int(cfg.protocol.cc.algo)] + j * (2 * s + 20))
    # a tick's chain: 7 barriers, and per phase a dependent shared-memory
    # load and a store read after the barrier (8 phases); the points run
    # side by side on separate SMs
    chain_cycles = 7 * BARRIER_CYCLES + 2 * 8 * SMEM_LATENCY_CYCLES
    clock = sm_clock_hz()
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": k * ticks * ops / F32_OPS_PER_S,
             "latency": ticks * chain_cycles / clock}
    model = max(times, key=times.get)
    return dict(bytes=nbytes, iter_slots_written=slots, ops=k * ticks * ops,
                bytes_ms=1e3 * times["bytes"],
                operations_ms=1e3 * times["operations"],
                latency_floor_ms=1e3 * times["latency"],
                latency_floor_us_per_tick=1e6 * chain_cycles / clock,
                chain_cycles=chain_cycles, sm_clock_hz=clock,
                bound_ms=1e3 * times[model], bound_model=model,
                # the chain is one of dependent operations
                bound_by="bytes" if model == "bytes" else "operations")


def phase_chunk_timing(kern, core, netsim, workload) -> dict:
    """One chunk at the main path's shape (fig7-reno WI, K=2, 187 ticks a
    chunk, from a state 40 chunks into the run): the kernel's launch on the
    packed state, as the main path makes it, against the plain version,
    bitwise and by CUDA events, beside the bound; the launch's dynamic
    shared memory (the library's size) and each specialization's registers
    and spills from the runtime."""
    from repro_torch.netsim import engine

    nc = kern["nc"]
    cfg = fig7_cfg(core, netsim, workload, "reno", 1, MAIN_SIM_TIME)
    sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
    statics = engine._build_statics(cfg, sweep.slope.device)
    wl = engine._workload_view(cfg, statics, sweep)
    run = nc.prepare(cfg, statics, sweep, wl)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    chunks = nc.ChunkRun(run, engine._init_state(cfg, statics, sweep), 40)
    for _ in range(40):
        chunks.step(engine.chunk_inputs(cfg, statics, sweep, chunks, tpc))
    st = nc.unpack_state(nc.pack_state(chunks.state()), chunks.key)
    inputs = engine.chunk_inputs(cfg, statics, sweep, st, tpc)
    plain = lambda: engine.run_chunk_reference(  # noqa: E731
        cfg, statics, sweep, wl, st, inputs)
    want = plain()
    cs = nc.pack_state(st)
    traces = nc.traces_for(cs, 1)
    nc.launch(run, cs, inputs, traces, 0)
    err, _ = compare_trees((nc.unpack_state(cs, inputs.key[-1]),
                            tuple(t[:, 0] for t in traces)), want)
    launch = lambda: nc.launch(run, cs, inputs, traces, 0)  # noqa: E731
    bound = chunk_bound(nc, cfg, st, want[0], run, inputs, traces)
    every = {f"algo{a}_var{v}_agg{int(g)}_fac{int(f)}":
             nc.kernel_attributes(a, v, g, f)
             for a in (0, 1, 2) for v in (0, 1, 2, 3)
             for g in (False, True) for f in (False, True)}
    main_attrs = every["algo0_var1_agg1_fac0"]
    if (main_attrs["registers"], main_attrs["local_bytes"]) != (
            UNARMED_FIG7_REGISTERS, 0):
        raise AssertionError(f"the unarmed fig7-reno specialization "
                             f"changed: {main_attrs}, expected "
                             f"{UNARMED_FIG7_REGISTERS} registers and no "
                             f"spill")
    out = dict(k=len(SEEDS), ticks=tpc, shape=nc.shape_of(cfg),
               smem_bytes=nc.launch_smem_bytes(run), threads=run.threads,
               ms=event_ms(launch, 20), plain_ms=event_ms(plain, 2, warm=1),
               max_abs_err=err, **bound,
               attributes=every["algo0_var1_agg1_fac0"],
               registers_range=[min(x["registers"] for x in every.values()),
                                max(x["registers"] for x in every.values())],
               spilling={name: x["local_bytes"] for name, x in every.items()
                         if x["local_bytes"]})
    out["ms_per_tick"] = out["ms"] / tpc
    emit("chunk_timing", **out)
    return out


def phase_profile(kern, core, netsim, workload) -> dict:
    """Profiler windows over both paths of the main path's WI sweep: the
    chunk path at its chunk size (40 chunks of 187 ticks) and 300 ticks of
    the per-tick path.  Each: the card's busy time per tick, its share of
    the (profiled) wall time, the device-side launches per tick and the
    kernel's own device time per launch.  The profiler adds host cost, so
    the busy share is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netsim import engine

    def window(cfg, per_tick, key):
        sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
        engine.run_ticks(cfg, sweep, per_tick=per_tick)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            engine.run_ticks(cfg, sweep, per_tick=per_tick)
            torch.cuda.synchronize()
            wall_s = time.time() - t0
        ticks = ticks_run(cfg)
        rows = device_rows(prof)
        busy_us = sum(_device_us(e) for e in rows)
        mine = [e for e in rows if key in e.key]
        n_kern = sum(e.count for e in mine)
        kern_us = sum(_device_us(e) for e in mine)
        top = sorted(rows, key=_device_us, reverse=True)[:8]
        return dict(
            ticks=ticks, wall_s=wall_s, device_busy_us=busy_us,
            busy_share=busy_us / (wall_s * 1e6),
            wall_us_per_tick=1e6 * wall_s / ticks,
            device_us_per_tick=busy_us / ticks,
            device_launches_per_tick=sum(e.count for e in rows) / ticks,
            kernel=key, kernel_launches=n_kern,
            kernel_device_us_per_launch=kern_us / n_kern if n_kern else None,
            kernel_device_us_per_tick=kern_us / ticks,
            top=[dict(name=e.key[:70], count=e.count, device_us=_device_us(e))
                 for e in top])

    chunk_cfg = fig7_cfg(core, netsim, workload, "reno", 1,
                         MAIN_SIM_TIME * 40 / 400, n_chunks=40)
    tick_cfg = fig7_cfg(core, netsim, workload, "reno", 1, 300 * DT)
    out = dict(chunk=window(chunk_cfg, False, "netsim_chunk_kernel"),
               per_tick=window(tick_cfg, True, "mltcp_step_kernel"))
    emit("profile", **out)
    return out


# ---------------------------------------------------------------------------
# experiment plans: the paper's fig 10 and fig 12 through run_plan
# ---------------------------------------------------------------------------

# The suites' own axes (benchmarks/speedup_vs_jobs.py,
# benchmarks/stragglers.py) at their REPRO_SMOKE depth and seed; fig 10
# Reno at seeds 1-3 (the reference's seeds in results/reference_plans.json:
# its spread across them is what settles whether the port's cells differ
# from the reference's by chaos).
PLAN_SIM_TIME = 1.5
PLAN_SEEDS = (1,)
FIG10_RENO_SEEDS = (1, 2, 3)
FIG10_JOBS = (2, 3, 4, 5, 6)
FIG12_PROBS = (0.0, 0.05, 0.10, 0.20, 0.30)
VARIANT = {"OFF": 0, "WI": 1}
# the JAX reference's numbers for the same plans, seeds 1-3
# (scripts/reference_plans.py); the cache the second fig 12 run reads
REFERENCE_PLANS = os.path.join(ROOT, "results", "reference_plans.json")
PLAN_CACHE = os.path.join(ROOT, "build", "plan_cache")
# One group at growing K: fig7-reno WI (N = 4) at 0.3 s, the point
# repeated across seeds 1..K, in the config's 400 chunks (37 ticks each)
# and in 80 (187 ticks, the main path's chunk size).
K_SCALING = (2, 21, 132, 264)
K_SIM_TIME = 0.3
K_CHUNKS = (400, 80)


def fig10_plan(core, netsim, workload, algo: str, seeds=PLAN_SEEDS):
    """speedup_vs_jobs._plan: variant x job count x seed on dumbbell(n, 2);
    the job counts pad into one group per variant."""
    def build(pt):
        n = pt["n_jobs"]
        return fig7_cfg(core, netsim, workload, algo, VARIANT[pt["variant"]],
                        PLAN_SIM_TIME,
                        topo=netsim.dumbbell(n, sockets_per_job=2),
                        models=("gpt2",) * n)
    return netsim.Plan(name=f"fig10-{algo}", build=build, axes=(
        netsim.Axis("variant", tuple(VARIANT)),
        netsim.Axis("n_jobs", FIG10_JOBS), netsim.Axis("seed", seeds)))


def fig12_plan(core, netsim, workload):
    """stragglers.make_plan: straggle probability (a sweep field) x scheme
    x seed, DCQCN with ECN, the Cassini leaves from the port's
    `workload.cassini_schedule`."""
    topo = netsim.dumbbell(2, sockets_per_job=2)
    sched, _ = workload.cassini_schedule(
        topo, [workload.profile_for("gpt2").scaled(WORK_SCALE)] * 2)

    def build(pt):
        return fig7_cfg(core, netsim, workload, "dcqcn",
                        VARIANT["WI" if pt["scheme"] == "mlqcn" else "OFF"],
                        PLAN_SIM_TIME, topo=topo,
                        cassini=sched if pt["scheme"] == "cassini" else None)
    return netsim.Plan(name="fig12", build=build, axes=(
        netsim.Axis("p", FIG12_PROBS, field="straggle_prob"),
        netsim.Axis("scheme", ("base", "mlqcn", "cassini")),
        netsim.Axis("seed", PLAN_SEEDS)))


def check_plan(pr, counts: dict, max_groups: int) -> dict:
    """At most ``max_groups`` groups, one chunk launch per chunk per group,
    no per-tick CC launch, no fallback, and a finite iteration on every
    job of every point."""
    import numpy as np

    cfg = pr.results[0].cfg
    want = dict(netsim_chunk=pr.n_compile_groups * n_chunks_run(cfg),
                mltcp_step=0, fallbacks=0, chunk_fallbacks=0)
    if not 1 <= pr.n_compile_groups <= max_groups or counts != want:
        raise AssertionError(f"plan {pr.plan.name}: {pr.n_compile_groups} "
                             f"groups, counts {counts}, expected {want}")
    for r in pr:
        if any(x.size == 0 or not np.all(np.isfinite(x))
               for x in r.iter_times):
            raise AssertionError(f"{pr.plan.name} {r.point.label()}: a job "
                                 f"recorded no finite iteration")
    return dict(n_compile_groups=pr.n_compile_groups,
                groups=[dict(k=g.n_points, n_jobs=g.n_jobs,
                             n_flows=g.n_flows, execute_s=g.execute_s)
                        for g in pr.profile.groups],
                points=len(pr), ticks=ticks_run(cfg), launches=counts,
                n_kernel_launches=pr.n_kernel_launches,
                n_kernel_fallbacks=pr.n_kernel_fallbacks)


def plan_cells(netsim, pr) -> dict:
    """Each cell's avg and p99 speedup per seed (the plan's seed order),
    seed-paired as the suites pair them: fig 10 WI over OFF per job count,
    fig 12 MLQCN and Cassini over base DCQCN per straggle probability; the
    layout of results/reference_plans.json."""
    def stats(base, test):
        per = [netsim.speedup_stats(b, t) for b, t in zip(base, test)]
        return {m: [p[m] for p in per]
                for m in ("avg_speedup", "p99_speedup")}
    if pr.plan.name == "fig12":
        return {f"{scheme}@{p}": stats(pr.select(p=p, scheme="base"),
                                       pr.select(p=p, scheme=scheme))
                for p in FIG12_PROBS for scheme in ("mlqcn", "cassini")}
    return {str(n): stats(pr.select(variant="OFF", n_jobs=n),
                          pr.select(variant="WI", n_jobs=n))
            for n in FIG10_JOBS}


def tier_b(name: str, cells: dict, ref: dict, seeds,
           metrics=("avg_speedup", "p99_speedup")) -> dict:
    """The port's cells against the reference's at the same seeds (each
    cell a {metric: [value per seed]}; None for "never", an infinite
    time).  The runs diverge chaotically (loss and CNP draws threshold on
    ``expm1``, which differs by a few ulp across frameworks), so the
    port's run is in effect one more seed: a metric's tolerance is the
    widest spread the reference itself shows across seeds 1-3 in any cell
    of the plan.  A value within it of the reference's (or None where the
    reference's is None) is inside.  Outside values are reported; more
    than half of a metric's values outside is a systematic gap and
    fails."""
    plan = ref["plans"][name]
    cols = [ref["seeds"].index(seed) for seed in seeds]
    out = {"seeds": list(seeds), "tolerance": {}, "cells": {},
           "outside": []}
    for metric in metrics:
        spreads = [max(v) - min(v) for v in (
            [x for x in c[metric] if x is not None]
            for c in plan["cells"].values()) if v]
        tol = max(spreads) if spreads else 0.0
        out["tolerance"][metric] = tol
        n_out = n = 0
        for cell, got in cells.items():
            for col, seed, value in zip(cols, seeds, got[metric]):
                want = plan["cells"][cell][metric][col]
                gap = (None if value is None or want is None
                       else float(value) - float(want))
                inside = (value is None and want is None) or (
                    gap is not None and abs(gap) <= tol)
                out["cells"].setdefault(cell, {}).setdefault(
                    metric, []).append(dict(seed=seed, port=value,
                                            reference=want, gap=gap))
                n += 1
                if not inside:
                    n_out += 1
                    out["outside"].append(dict(
                        cell=cell, seed=seed, metric=metric, port=value,
                        reference=want, gap=gap, tolerance=tol))
        if 2 * n_out > n:
            raise AssertionError(f"{name}: {n_out} of {n} values outside "
                                 f"the {metric} tolerance {tol}: "
                                 f"{out['outside']}")
    return out


def seed_spread(name: str, cells: dict, ref: dict, cell: str, metric: str,
                tol: float) -> dict:
    """One cell of a multi-seed plan against the reference at the same
    seeds: each seed's gap and whether it is outside the plan's tolerance
    ``tol``, and the gap between the two packages' means over the seeds.
    The cell's gap reads as chaos, not a fault, when it is not outside at
    every seed and the port's own spread across its seeds covers the gap
    of the means; a fault would stay outside at every seed."""
    port = cells[cell][metric]
    want = ref["plans"][name]["cells"][cell][metric]
    gaps = [p - w for p, w in zip(port, want)]
    spread = max(port) - min(port)
    mean_gap = statistics.mean(port) - statistics.mean(want)
    outside = [abs(g) > tol for g in gaps]
    return dict(cell=cell, metric=metric, port=port, reference=want,
                gaps=gaps, tolerance=tol, outside=outside,
                port_spread=spread, reference_spread=max(want) - min(want),
                mean_gap=mean_gap,
                chaos=bool(not all(outside) and abs(mean_gap) <= spread))


def compare_prefix(padded, slot: int, alone) -> dict:
    """Raise unless every leaf of point ``slot`` of a padded group's output
    equals the K=1 run ``alone`` bitwise on the active jobs and flows, the
    prefix of each padded axis."""
    a, b = named_leaves(padded), named_leaves(alone)
    if [n for n, _ in a] != [n for n, _ in b]:
        raise AssertionError("the two outputs have different leaves")
    cut = 0
    for (name, g), (_, w) in zip(a, b):
        g, w = g[slot], w[0]
        cut += tuple(g.shape) != tuple(w.shape)
        compare_trees([g[tuple(slice(0, n) for n in w.shape)]], [w],
                      what=f"padded point != unpadded run on {name}")
    return dict(leaves=len(a), cut_to_active=cut)


def padded_vs_alone(kern, netsim, plan, n_jobs: int) -> dict:
    """The WI point with ``n_jobs`` jobs of a fig 10 plan, run in its padded
    group (the group's sweep as `run_plan` stacks it) and alone on its own
    fabric, both through the chunk kernel."""
    from repro_torch.netsim import experiment

    points, cfgs, overrides, groups = experiment.resolve_plan(plan)
    i = next(i for i, pt in enumerate(points)
             if pt["variant"] == "WI" and pt["n_jobs"] == n_jobs)
    group = next(g for g in groups if i in g.idxs)
    sweep = experiment.group_sweep(cfgs, overrides, group, device=DEVICE)
    padded, _, counts = run_counted(kern, group.cfg, sweep)
    check_counts("padded group", group.cfg, counts)
    alone, _, counts = run_counted(
        kern, cfgs[i], netsim.make_sweep(cfgs[i], device=DEVICE,
                                         seed=[points[i]["seed"]]))
    check_counts("unpadded point", cfgs[i], counts)
    return dict(point=points[i], group_k=len(group.idxs),
                group_jobs=group.cfg.jobs.n_jobs, bitwise=True,
                **compare_prefix(padded, group.idxs.index(i), alone))


def same_results(a, b) -> bool:
    import numpy as np

    return all(
        x.point.axes == y.point.axes
        and all(np.array_equal(p, q) for p, q in zip(x.iter_times,
                                                     y.iter_times))
        and all(np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("trace_t", "trace_util", "trace_incomm",
                          "trace_drops", "trace_jobtput"))
        for x, y in zip(a, b))


def k_scaling(kern, core, netsim, workload) -> list:
    """One group at K = 2 .. 264 (fig7-reno WI, the point repeated across
    seeds) at each chunk count of K_CHUNKS."""
    return [k_row(kern, netsim, fig7_cfg(core, netsim, workload, "reno", 1,
                                         K_SIM_TIME, n_chunks=n_chunks), k)
            for n_chunks in K_CHUNKS for k in K_SCALING]


def k_row(kern, netsim, cfg, k: int) -> dict:
    """Wall µs per tick of a K-point group (median of three synchronized
    runs after a first), the card's busy time per tick and the chunk
    kernel's own (a profiled run), the host's `chunk_inputs` per tick
    apart (100 chunks), and µs per point-tick; ``paced_by`` names the
    larger of the host's time and the kernel's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ticks = ticks_run(cfg)
    seeds = list(range(1, k + 1))
    sweep = netsim.make_sweep(cfg, device=DEVICE, seed=seeds)
    walls = []
    for _ in range(4):
        _, seconds, counts = run_counted(kern, cfg, sweep)
        check_counts(f"K={k}", cfg, counts)
        walls.append(seconds)
    wall_s = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        netsim.simulate_sweep(cfg, sweep, device=DEVICE)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    kern_us = sum(_device_us(e) for e in rows
                  if "netsim_chunk_kernel" in e.key)
    host = host_inputs(cfg, n=100, seeds=seeds, numpy_draws=False)
    row = dict(k=k, ticks=ticks, ticks_per_chunk=host["ticks_per_chunk"],
               wall_s=walls, wall_us_per_tick=1e6 * wall_s / ticks,
               device_busy_us_per_tick=sum(_device_us(e) for e in rows)
               / ticks,
               kernel_us_per_tick=kern_us / ticks,
               host_chunk_inputs_us_per_tick=host["chunk_inputs_us_per_tick"],
               c_draws_us_per_tick=host["c_draws_us_per_tick"],
               us_per_point_tick=1e6 * wall_s / ticks / k)
    row["paced_by"] = ("host" if row["host_chunk_inputs_us_per_tick"]
                       > row["kernel_us_per_tick"] else "kernel")
    return row


def phase_plans(kern, core, netsim, workload) -> dict:
    """The paper's fig 10 (Reno and DCQCN) and fig 12 plans through
    `netsim.run_plan` on the card, each counted on its own; their cells
    against the reference's numbers (Tier B); a padded point against its
    unpadded run, bitwise; the fig 12 plan again from the cache; and the
    chunk kernel's time per tick as one group's K grows."""
    import shutil

    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    out, plans = {}, {}
    for algo, seeds in (("reno", FIG10_RENO_SEEDS), ("dcqcn", PLAN_SEEDS)):
        plans[f"fig10-{algo}"] = (fig10_plan(core, netsim, workload, algo,
                                             seeds), 2, {}, seeds)
    shutil.rmtree(PLAN_CACHE, ignore_errors=True)
    plans["fig12"] = (fig12_plan(core, netsim, workload), 2,
                      dict(cache_dir=PLAN_CACHE), PLAN_SEEDS)
    results = {}
    for name, (plan, max_groups, kw, seeds) in plans.items():
        pr, seconds, counts = counted(
            kern, lambda: netsim.run_plan(plan, device=DEVICE, **kw))
        info = check_plan(pr, counts, max_groups)
        if name.startswith("fig10") and (
                info["n_compile_groups"] != 2
                or any((g["k"], g["n_jobs"], g["n_flows"])
                       != (5 * len(seeds), 6, 12) for g in info["groups"])):
            raise AssertionError(f"{name}: groups {info['groups']}, "
                                 f"expected two of K={5 * len(seeds)} on "
                                 f"6 jobs x 2 flows")
        cells = plan_cells(netsim, pr)
        results[name] = pr
        out[name] = dict(seconds=seconds,
                         us_per_tick=1e6 * seconds / info["ticks"],
                         **info, cells=cells,
                         tier_b=tier_b(name, cells, ref, seeds))
    # ROADMAP queue 3 item 1: fig 10 Reno 6 jobs, p99, against the
    # reference's seeds 1-3
    out["fig10_reno_6_jobs_p99"] = seed_spread(
        "fig10-reno", out["fig10-reno"]["cells"], ref, "6", "p99_speedup",
        out["fig10-reno"]["tier_b"]["tolerance"]["p99_speedup"])
    out["padded_vs_alone"] = padded_vs_alone(kern, netsim,
                                             plans["fig10-reno"][0], 3)
    again, seconds, counts = counted(kern, lambda: netsim.run_plan(
        plans["fig12"][0], device=DEVICE, cache_dir=PLAN_CACHE))
    if (again.n_cache_hits != len(again) or again.n_compile_groups
            or any(counts.values())
            or not same_results(results["fig12"], again)):
        raise AssertionError(f"fig12 from the cache: {again.n_cache_hits} "
                             f"hits of {len(again)}, "
                             f"{again.n_compile_groups} groups, {counts}")
    out["cache"] = dict(hits=again.n_cache_hits, points=len(again),
                        launches=counts, seconds=seconds, equal=True)
    out["k_scaling"] = k_scaling(kern, core, netsim, workload)
    out["reference_source"] = os.path.relpath(REFERENCE_PLANS, ROOT)
    out["outside_tolerance"] = [dict(plan=name, **o) for name in plans
                                for o in out[name]["tier_b"]["outside"]]
    emit("plans", **out)
    return out


# ---------------------------------------------------------------------------
# telemetry and faults: the fig 5 timeline and the churn gauntlet plans
# ---------------------------------------------------------------------------

# benchmarks/timeline.py at REPRO_SMOKE depth (common.SIM_TIME), seeds 1-3
FIG5_SIM_TIME = 1.5
FIG5_SEEDS = (1, 2, 3)
FIG5_PROBES = ("flow_cwnd", "flow_rate", "link_queue", "link_mark_rate",
               "job_incomm", "job_iter", "interleave_overlap")
# paper §4.1: TCP jobs open parallel sockets, RoCE one QP (both suites)
SUITE_SOCKETS = {"reno": 2, "cubic": 2, "dcqcn": 1}
MAX_TTI_ITERS = 10.0
FIG5_METRICS = ("tti_iters", "tti_seconds", "interleave_stability",
                "p50_iter_s", "p99_iter_s")
# benchmarks/churn.py: three GPT-2 jobs on a 100 Gbps dumbbell for
# 18 s x WORK_SCALE, an 8-row schedule of churn, flaps and blackholes
CHURN_SIM_TIME = 18.0 * WORK_SCALE
CHURN_CAP_GBPS = 100.0
CHURN_JOBS = 3
CHURN_SEEDS = (1, 2, 3)
CHURN_SCHEDULES = ("gauntlet", "staggered")
# label -> (churned job, blackholed job, arrival, departure, re-arrival,
# blackhole window, flap window and scale), as fractions of the run
CHURN_EVENTS = {
    "gauntlet": (2, 0, 0.08, 0.30, 0.38, (0.18, 0.22), (0.50, 0.64, 0.88)),
    "staggered": (1, 2, 0.10, 0.32, 0.40, (0.20, 0.24), (0.52, 0.66, 0.9)),
}
CHURN_MAX_ITERS = 10.0
CHURN_EXEMPT = ("blackhole-active", "cold-start")
CHURN_REQUIRED = ("departure", "arrival", "re-arrival", "flap", "flap-clear",
                  "blackhole-clear")
CHURN_ML_MIN_STABILITY = 0.95
CHURN_BASE_MARGIN = {"reno": 0.02, "cubic": 0.02, "dcqcn": 0.0}
CHURN_METRICS = ("interleave_stability", "max_reinterleave_iters")


def reference_plan_script():
    """scripts/reference_plans.py as a module (its cell extraction reads a
    PlanResult of either package through the netsim accessors; it imports
    nothing of the reference until its main runs)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import reference_plans
    return reference_plans


def fig5_spec(netsim):
    """timeline.telemetry_spec: the suite's probes, ~1000 samples a run."""
    n_ticks = int(round(FIG5_SIM_TIME / DT))
    return netsim.TelemetrySpec(probes=FIG5_PROBES,
                                stride=max(1, n_ticks // 1000))


def fig5_plan(core, netsim, workload):
    """timeline.make_plan: algo x variant x seed, two GPT-2 jobs on
    dumbbell(2, sockets per algo)."""
    def build(pt):
        algo = pt["algo"]
        return fig7_cfg(core, netsim, workload, algo, VARIANT[pt["variant"]],
                        FIG5_SIM_TIME, topo=netsim.dumbbell(
                            2, sockets_per_job=SUITE_SOCKETS[algo]))
    return netsim.Plan(name="fig5-timeline", build=build, axes=(
        netsim.Axis("algo", tuple(SUITE_SOCKETS)),
        netsim.Axis("variant", tuple(VARIANT)),
        netsim.Axis("seed", FIG5_SEEDS)))


def fig5_claims(cells: dict) -> dict:
    """timeline._summarize's assertions per algorithm on {algo/variant:
    per-seed values}: every MLTCP seed interleaves within MAX_TTI_ITERS
    iterations, no baseline seed converges."""
    out = {}
    for algo in SUITE_SOCKETS:
        ml, base = cells[f"{algo}/WI"], cells[f"{algo}/OFF"]
        failed = []
        if not all(x is not None and x <= MAX_TTI_ITERS
                   for x in ml["tti_iters"]):
            failed.append(f"MLTCP time to interleave {ml['tti_iters']} "
                          f"exceeds {MAX_TTI_ITERS}")
        if any(base["converged"]):
            failed.append(f"baseline interleaved: {base['converged']}")
        out[algo] = dict(tti_iters=ml["tti_iters"], failed=failed)
    return out


def armed_turns(kern, core, netsim, workload) -> dict:
    """fig7-reno WI at 1.5 s (K = 2 seeds) unarmed and with the fig 5
    spec armed, in turns (unarmed, armed, armed, unarmed): µs per tick."""
    import dataclasses

    base = fig7_cfg(core, netsim, workload, "reno", 1, MAIN_SIM_TIME)
    cfgs = {"unarmed": base,
            "armed": dataclasses.replace(base, telemetry=fig5_spec(netsim))}
    turns = []
    for name in ("unarmed", "armed", "armed", "unarmed"):
        cfg = cfgs[name]
        _, seconds, counts = run_counted(kern, cfg)
        check_counts(f"turn {name}", cfg, counts)
        turns.append(dict(run=name, seconds=seconds,
                          us_per_tick=1e6 * seconds / ticks_run(cfg)))
    med = {name: statistics.median(t["us_per_tick"] for t in turns
                                   if t["run"] == name) for name in cfgs}
    return dict(turns=turns, unarmed_us_per_tick=med["unarmed"],
                armed_us_per_tick=med["armed"],
                armed_over_unarmed=med["armed"] / med["unarmed"])


def sketch_check(nc, netsim) -> dict:
    """The iteration-time sketch's one transcendental on the card: the
    chunk kernel's ``logf`` against ``torch.log`` on CUDA, and its bins
    against `telemetry.sketch_bins`, on every float32 in [sketch_lo,
    sketch_hi] (one launch).  Unequal bins would break the kernel's bitwise
    parity with the per-tick path and fail."""
    import numpy as np
    import torch

    from repro_torch.netsim import telemetry

    spec = netsim.TelemetrySpec()
    lo, hi = (int(np.float32(v).view(np.int32))
              for v in (spec.sketch_lo, spec.sketch_hi))
    x = torch.arange(lo, hi + 1, dtype=torch.int32,
                     device=DEVICE).view(torch.float32)
    logs, bins = nc.sketch_check(x, spec)
    log_diff = int((logs.view(torch.int32)
                    != torch.log(x).view(torch.int32)).sum())
    bin_diff = int((bins != telemetry.sketch_bins(x, spec)).sum())
    out = dict(values=x.numel(), lo=spec.sketch_lo, hi=spec.sketch_hi,
               log_differs=log_diff, bins_differ=bin_diff)
    del x, logs, bins
    torch.cuda.empty_cache()
    if bin_diff:
        raise AssertionError(f"sketch bins: kernel != torch on {bin_diff} "
                             f"float32 values: {out}")
    return out


def phase_telemetry(kern, core, netsim, workload) -> dict:
    """The fig 5 timeline plan (benchmarks/timeline.py) through the port's
    `run_plan` with the suite's telemetry spec on the card, counted: the
    suite's assertions, each cell beside the reference's
    (results/reference_plans.json, Tier B as the plans phase), the groups
    equal to the reference's; the sketch's logf on the card; and fig7-reno
    µs per tick armed and unarmed in turns."""
    rp = reference_plan_script()
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    want = ref["plans"]["fig5"]
    plan = fig5_plan(core, netsim, workload)
    pr, seconds, counts = counted(kern, lambda: netsim.run_plan(
        plan, device=DEVICE, telemetry=fig5_spec(netsim)))
    info = check_plan(pr, counts, want["n_compile_groups"])
    if info["n_compile_groups"] != want["n_compile_groups"]:
        raise AssertionError(f"fig5: {info['n_compile_groups']} groups, the "
                             f"reference {want['n_compile_groups']}")
    cells = rp.timeline_cells(netsim, pr)
    claims = fig5_claims(cells)
    failed = {a: c["failed"] for a, c in claims.items() if c["failed"]}
    if failed:
        raise AssertionError(f"fig5: the suite's assertions fail: {failed}")
    out = dict(seconds=seconds, us_per_tick=1e6 * seconds / info["ticks"],
               **info, cells=cells, claims=claims,
               reference_claims=fig5_claims(want["cells"]),
               tier_b=tier_b("fig5", cells, ref, FIG5_SEEDS, FIG5_METRICS),
               sketch=sketch_check(kern["nc"], netsim),
               fig7_reno=armed_turns(kern, core, netsim, workload))
    emit("telemetry", **out)
    return out


def churn_events(netsim, cfg, label: str) -> list:
    """churn._events: the labeled gauntlet on ``cfg``'s fabric."""
    t = cfg.sim_time
    churn_job, bh_job, arr, dep, rearr, bh, flap = CHURN_EVENTS[label]
    bh_flow = [int(f) for f in
               (cfg.topo.flow_to_job == bh_job).nonzero()[0]][:1]
    return [
        netsim.job_departs(0.0, churn_job),
        netsim.job_arrives(arr * t, churn_job),
        netsim.job_departs(dep * t, churn_job),
        netsim.job_arrives(rearr * t, churn_job),
        netsim.link_flap(flap[0] * t, flap[1] * t, 0, flap[2]),
        netsim.blackhole(bh[0] * t, bh[1] * t, bh_flow),
    ]


def churn_window_names(label: str) -> dict:
    """churn._window_names: start tick -> window name."""
    t = CHURN_SIM_TIME
    _, _, arr, dep, rearr, bh, flap = CHURN_EVENTS[label]

    def tick(x):
        return max(0, int(round(x / DT)))
    return {0: "cold-start", tick(arr * t): "arrival",
            tick(dep * t): "departure", tick(rearr * t): "re-arrival",
            tick(flap[0] * t): "flap", tick(flap[1] * t): "flap-clear",
            tick(bh[0] * t): "blackhole-active",
            tick(bh[1] * t): "blackhole-clear"}


def churn_spec(netsim):
    """churn.telemetry_spec: overlap and iterations, the three detectors,
    the 0.8 overlap threshold, ~1000 samples a run."""
    n_ticks = int(round(CHURN_SIM_TIME / DT))
    return netsim.TelemetrySpec(
        probes=("interleave_overlap", "job_iter"),
        detectors=("interleave", "iter_sketch", "reinterleave"),
        overlap_threshold=0.8, stride=max(1, n_ticks // 1000))


def churn_plan(core, netsim, workload):
    """churn.make_plan: algo x variant x schedule x seed; the schedule a
    ``field="*"`` axis resolving, per point config, to the schedule's
    sweep overrides."""
    faults = netsim.FaultSpec(n_events=8, churn=True, link_flaps=True,
                              blackholes=True)
    tel = churn_spec(netsim)

    def build(pt):
        algo = pt["algo"]
        return fig7_cfg(core, netsim, workload, algo, VARIANT[pt["variant"]],
                        CHURN_SIM_TIME, topo=netsim.dumbbell(
                            CHURN_JOBS, sockets_per_job=SUITE_SOCKETS[algo],
                            cap_gbps=CHURN_CAP_GBPS),
                        models=("gpt2",) * CHURN_JOBS, faults=faults,
                        telemetry=tel)

    def schedule(label):
        return lambda cfg: netsim.fault_schedule(
            cfg, churn_events(netsim, cfg, label), spec=faults).overrides()
    return netsim.Plan(name="churn-gauntlet", build=build, axes=(
        netsim.Axis("algo", tuple(SUITE_SOCKETS)),
        netsim.Axis("variant", tuple(VARIANT)),
        netsim.Axis("schedule", CHURN_SCHEDULES, field="*",
                    resolve=schedule),
        netsim.Axis("seed", CHURN_SEEDS)))


def churn_claims(cells: dict) -> dict:
    """churn._summarize's assertions per (algo, schedule) on {algo/variant/
    schedule: per-seed reports}: after every non-exempt fault window MLTCP
    re-interleaves within CHURN_MAX_ITERS iterations (worst over seeds),
    every required window is seen, MLTCP stability holds, no baseline run
    re-converges from every window, and the baseline's stability sits
    below MLTCP's by the algorithm's margin.  Each failure names its kind
    and, for the first two, its windows."""
    out = {}
    for algo in SUITE_SOCKETS:
        for label in CHURN_SCHEDULES:
            ml = cells[f"{algo}/WI/{label}"]
            base = cells[f"{algo}/OFF/{label}"]
            names = churn_window_names(label)
            worst: dict = {}
            for events in ml["events"]:
                for e in events:
                    name = names.get(e["start_tick"],
                                     f"tick{e['start_tick']}")
                    it = e["reinterleave_iters"]
                    it = float("inf") if it is None else it
                    worst[name] = max(worst.get(name, 0.0), it)
            held = {k: v for k, v in worst.items() if k not in CHURN_EXEMPT}
            ml_stab = min(ml["interleave_stability"])
            base_stab = max(base["interleave_stability"])
            failed = []
            missing = [w for w in CHURN_REQUIRED if w not in held]
            if missing:
                failed.append(dict(kind="missing", windows=missing,
                                   msg="fault windows never observed"))
            bad = {k: v for k, v in held.items() if v > CHURN_MAX_ITERS}
            if bad:
                failed.append(dict(
                    kind="reinterleave", windows=sorted(bad),
                    msg=f"MLTCP re-interleave over {CHURN_MAX_ITERS} "
                        f"iterations: {bad}"))
            if ml_stab < CHURN_ML_MIN_STABILITY:
                failed.append(dict(kind="ml_stability",
                                   msg=f"MLTCP stability {ml_stab}"))
            if any(base["all_events_reconverged"]):
                failed.append(dict(kind="baseline_reconverged",
                                   msg="a baseline run re-converged after "
                                       "every fault window"))
            if base_stab > ml_stab - CHURN_BASE_MARGIN[algo]:
                failed.append(dict(
                    kind="margin",
                    msg=f"baseline stability {base_stab} not below MLTCP's "
                        f"{ml_stab} by {CHURN_BASE_MARGIN[algo]}"))
            out[f"{algo}/{label}"] = dict(
                worst_reinterleave_iters={k: (None if v == float("inf")
                                              else v)
                                          for k, v in worst.items()},
                ml_stability=ml_stab, baseline_stability=base_stab,
                failed=failed)
    return out


def unshared_failures(claim: dict, ref_claim: dict) -> list:
    """The failures of one churn cell's `churn_claims` that the reference's
    same cell does not share: a kind the reference holds, or a window the
    reference holds of a kind it fails."""
    ref = {f["kind"]: set(f.get("windows", ())) for f in ref_claim["failed"]}
    out = []
    for f in claim["failed"]:
        if f["kind"] not in ref:
            out.append(f)
        elif "windows" in f:
            extra = [w for w in f["windows"] if w not in ref[f["kind"]]]
            if extra:
                out.append(dict(f, windows=extra))
    return out


def phase_faults(kern, core, netsim, workload) -> dict:
    """The churn gauntlet (benchmarks/churn.py) through the port's
    `run_plan` on the card, counted: each of the suite's assertions held
    in every cell, but for those the reference itself fails in that cell
    on the same seeds (results/reference_plans.json: at seeds 1-3 it
    fails Reno's re-interleave bound after flap-clear and, in the
    gauntlet, re-arrival), assertion by assertion and window by window;
    each cell beside the reference's (Tier B); the groups equal to the
    reference's."""
    rp = reference_plan_script()
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    want = ref["plans"]["churn"]
    plan = churn_plan(core, netsim, workload)
    pr, seconds, counts = counted(
        kern, lambda: netsim.run_plan(plan, device=DEVICE))
    info = check_plan(pr, counts, want["n_compile_groups"])
    if info["n_compile_groups"] != want["n_compile_groups"]:
        raise AssertionError(f"churn: {info['n_compile_groups']} groups, "
                             f"the reference {want['n_compile_groups']}")
    cells = rp.churn_cells(netsim, pr)
    claims, ref_claims = churn_claims(cells), churn_claims(want["cells"])
    failed = {cell: bad for cell, c in claims.items()
              if (bad := unshared_failures(c, ref_claims[cell]))}
    if failed:
        raise AssertionError(f"churn: the suite's assertions fail where the "
                             f"reference holds them: {failed}")
    worst = max((v for c in claims.values()
                 for name, v in c["worst_reinterleave_iters"].items()
                 if name not in CHURN_EXEMPT and v is not None),
                default=None)
    out = dict(seconds=seconds, us_per_tick=1e6 * seconds / info["ticks"],
               **info, cells=cells, claims=claims,
               reference_claims=ref_claims,
               worst_reinterleave_iters=worst,
               tier_b=tier_b("churn", cells, ref, CHURN_SEEDS,
                             CHURN_METRICS))
    emit("faults", **out)
    return out


# ---------------------------------------------------------------------------
# serving: the language-model kernels and recurrentgemma-2b
# ---------------------------------------------------------------------------

# (b, t, s, h, kv, dh, causal, window, softcap, dtype): the JAX package's
# flash test matrix (tests/test_kernels.py), then the kernel's tile edges
# (64-query, 32-key tiles): T and S not multiples of either, S != T without
# the causal mask (with and without a window), D=256 with the softcap,
# D=256 bf16 at T=1024 with window 512, and a ragged serve-like shape
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, None, "float32"),
    (1, 256, 256, 4, 2, 64, True, 0, None, "float32"),
    (2, 128, 128, 4, 1, 32, True, 0, None, "float32"),
    (1, 256, 256, 2, 2, 128, True, 64, None, "float32"),
    (1, 128, 128, 2, 2, 64, True, 0, 50.0, "float32"),
    (2, 128, 128, 4, 4, 64, False, 0, None, "float32"),
    (1, 192, 192, 2, 2, 64, True, 0, None, "float32"),
    (2, 128, 128, 4, 4, 64, True, 0, None, "bfloat16"),
    (1, 100, 100, 2, 1, 64, True, 0, None, "float32"),
    (2, 80, 150, 4, 2, 128, False, 0, None, "float32"),
    (1, 96, 200, 2, 2, 192, False, 40, None, "float32"),
    (2, 70, 70, 4, 4, 32, True, 16, None, "float32"),
    (1, 300, 300, 4, 1, 256, True, 0, 30.0, "float32"),
    (1, 1024, 1024, 4, 1, 256, True, 512, None, "bfloat16"),
    (1, 77, 77, 2, 1, 64, True, 0, None, "bfloat16"),
    (1, 1000, 1000, 10, 1, 256, True, 300, None, "float32"),
]
SERVE_ARCH = "recurrentgemma-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 4096, 16
# the attention of the serve prefill (recurrentgemma-2b: 10 query heads
# over 1 KV head of width 256, window 2048), in FLASH_CASES' layout
SERVE_FLASH_CASE = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 10, 1, 256,
                    True, 2048, None, "float32")
# RG-LRU bitwise checks, each in f32 and bf16, with and without h0: the
# serve shape (timed), then the edges of the kernel's ring and routes
# (16-row tiles; 16-byte copies only where every row is 16-byte aligned)
RGLRU_SHAPES = ((SERVE_BATCH, SERVE_PROMPT, 2560),
                (3, 33, 130),   # D * elt not a multiple of 16 B: general
                (2, 1, 2560),   # T = 1
                (2, 9, 2560),   # T below one tile (16 rows)
                (2, 77, 136))   # T not a whole tile, a ragged last unit
# (shape, bytes): `a` starts that many bytes past a 16-byte boundary of its
# storage, contiguous all the same
RGLRU_OFFSET_CASE = ((2, 70, 256), 4)
# the attention of the families' prefills at their full widths:
# deepseek-moe-16b's causal layers (16 heads of 128, batch 1 x 4096),
# seamless-m4t-medium's bidirectional encoder (16 heads of 64, batch 4 x
# 1024 frames) and its decoder's causal self-attention (batch 4 x 4096)
FAMILY_FLASH_CASES = {
    "deepseek-moe-16b": (1, 4096, 4096, 16, 16, 128, True, 0, None,
                         "float32"),
    "seamless-m4t-medium/encoder": (4, 1024, 1024, 16, 16, 64, False, 0,
                                    None, "float32"),
    "seamless-m4t-medium/decoder": (4, 4096, 4096, 16, 16, 64, True, 0,
                                    None, "float32"),
}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:34"
RGLRU_REPLACES = "src/repro/kernels/rg_lru.py:24"
# Serve prefill, kernel path vs plain path on the card: both are float32
# with rounding differences only (online vs dense softmax, sequential vs
# log-depth scan), so every logit and cache tensor must agree to 1e-3 of
# its largest magnitude; a wrong mask, head mapping or state would be off
# by O(1) of it.
SERVE_REL_BOUND = 1e-3
# A MoE token whose expert set differs between the kernel and plain
# prefills is excused (the plain path replays the kernel run's routing)
# only where its top-k router margin in the kernel run lies below this:
# the two paths' hidden states differ by rounding (~1e-6 relative), so a
# flip at a wider margin means an error the bound must catch.  The CPU
# tests assert the same margin at their seed (tests/test_torch_moe.py).
FLIP_MARGIN = 1e-5
DECODE_TURNS = 5


def _tdtype(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def attention_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, per (batch, head)."""
    total = 0
    for q in range(t):
        hi = min(q, s - 1) if causal else s - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound(b, t, s, h, kv, dh, causal, window, elt=4):
    """(bound_ms, bound_by, flop, bytes): q.k and p.v are 2·D flops each per
    unmasked pair; q, k, v read once and the output written once."""
    flop = 4 * dh * b * h * attention_pairs(t, s, causal, window)
    nbytes = elt * (2 * b * t * h * dh + 2 * b * s * kv * dh)
    t_ops, t_bytes = flop / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flop, nbytes)


def split_tf32_floor_ms(flop: int) -> float:
    """The floor of the kernel's f32 scheme: three TF32 tensor-core products
    (hi·hi, hi·lo, lo·hi) per f32 product, at the TF32 peak."""
    return 1e3 * 3 * flop / TF32_OPS_PER_S


# torch.nn.attention.SDPBackend members timed as the flash row's yardstick
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_backends(q, k, v, mask, want) -> list:
    """F.scaled_dot_product_attention on the serve case under each backend
    alone: first with ``enable_gqa=True`` on the one KV head, and where the
    backend refuses that, with K/V expanded to the query heads beforehand
    (the expansion is outside the timed call).  A backend that refuses both
    is recorded with its reason."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    h = q.shape[2]
    qt = q.transpose(1, 2)
    rows = []
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            rows.append(dict(backend=name, accepted=False,
                             reason="not in this torch"))
            continue
        reasons = []
        for gqa in (True, False):
            if gqa:
                kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            else:
                kt = k.repeat_interleave(h // k.shape[2], 2).transpose(1, 2)
                vt = v.repeat_interleave(h // v.shape[2], 2).transpose(1, 2)

            def call(kt=kt, vt=vt, gqa=gqa):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=gqa
                ).transpose(1, 2)
            try:
                with sdpa_kernel([backend]), \
                        warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = call()
                    torch.cuda.synchronize()
                    err = float((out - want).abs().max())
                    del out
                    row = dict(backend=name, accepted=True,
                               kv="enable_gqa=True" if gqa else
                               f"expanded to {h} heads",
                               ms=event_ms(call, 5),
                               back_to_back_ms=back_to_back_ms(call, 3),
                               max_abs_err=err)
            except RuntimeError as e:
                said = [str(w.message).strip().splitlines()[0][:160]
                        for w in caught]
                reasons.append(said or str(e).strip().splitlines()[0][:160])
                continue
            rows.append(row)
            break
        else:
            rows.append(dict(backend=name, accepted=False, reason=reasons))
        del kt, vt
        torch.cuda.empty_cache()
    return rows


def flash_operands(case, gen):
    """Random q, k, v on the card for one FLASH_CASES entry."""
    import torch

    b, t, s, h, kv, dh, *_, dtype = case
    return tuple(torch.randn(shape, generator=gen, device=DEVICE
                             ).to(_tdtype(dtype))
                 for shape in ((b, t, h, dh), (b, s, kv, dh), (b, s, kv, dh)))


def flash_checks(fa, ref, gen) -> list:
    """The flash kernel against its plain version on every FLASH_CASES entry
    and the serve case, within FLASH_TOL; raises outside it."""
    import torch

    checks = []
    for case in (FLASH_CASES + [SERVE_FLASH_CASE]
                 + list(FAMILY_FLASH_CASES.values())):
        *_, causal, window, cap, dtype = case
        q, k, v = flash_operands(case, gen)
        got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap).float()
        want = ref.ref_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap).float()
        tol = FLASH_TOL[dtype]
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"flash kernel vs plain version outside "
                                 f"{tol} at {case}: max |diff| {err}")
        checks.append(dict(case=list(case), max_abs_err=err, tol=tol))
        del q, k, v, got, want
    return checks


def flash_attributes(fa) -> dict:
    """Registers, spills and shared memory of every flash instantiation,
    from the runtime; raises if any of them spills."""
    attrs = {f"{dt}_d{d}": fa.kernel_attributes(_tdtype(dt), d)
             for dt in ("float32", "bfloat16") for d in fa.HEAD_DIMS}
    spilled = {key: a for key, a in attrs.items() if a["local_bytes"]}
    if spilled:
        raise AssertionError(f"flash kernel instantiations with local "
                             f"memory (spills): {spilled}")
    return attrs


def probe_flash(fa, ref, sources) -> dict:
    """``--probe-flash``: build the kernels, hold the checkout's flash kernel
    and each of ``sources`` (other ``flash_attention.cu`` files, built with
    the kernel's own flags) to the plain version, and time the serve case
    back to back in turns on this card."""
    from pathlib import Path

    import torch
    from repro_torch.kernels import build

    libs = {"checkout": fa.LIBRARY}
    for i, path in enumerate(sources):
        lib = build.KernelLibrary(f"flash_attention_probe{i}",
                                  fa._bind_launch, flags=fa.NVCC_FLAGS)
        lib.source = Path(path).resolve()
        libs[path] = lib
    phase_device(list(libs.values()))
    gen = torch.Generator(device=DEVICE)
    out = {name: {} for name in libs}
    for name, lib in libs.items():
        fa.LIBRARY = lib
        gen.manual_seed(12)
        out[name]["max_abs_err"] = [c["max_abs_err"]
                                    for c in flash_checks(fa, ref, gen)]
        out[name]["back_to_back_ms"] = []
    fa.LIBRARY = libs["checkout"]
    out["checkout"]["attributes"] = flash_attributes(fa)

    q, k, v = flash_operands(SERVE_FLASH_CASE, gen)
    causal, window = SERVE_FLASH_CASE[6:8]
    for name in list(sources) + ["checkout"] * 2 + list(sources)[::-1]:
        fa.LIBRARY = libs[name]
        out[name]["back_to_back_ms"].append(back_to_back_ms(
            lambda: fa.flash_attention(q, k, v, causal=causal,
                                       window=window), 10))
    fa.LIBRARY = libs["checkout"]
    emit("probe_flash", cases=[list(c) for c in
                               FLASH_CASES + [SERVE_FLASH_CASE]],
         sources=out)
    return out


def rglru_route_taken(rl, fn):
    """(fn's result, the one RG-LRU specialization its launches took, as
    the wrapper counted them in ``ROUTE_LAUNCHES``); raises unless fn
    launched the kernel and took one specialization."""
    before = dict(rl.ROUTE_LAUNCHES)
    result = fn()
    taken = [r for r, n in rl.ROUTE_LAUNCHES.items() if n > before[r]]
    if len(taken) != 1:
        raise AssertionError(f"rg_lru launches took routes {taken}, "
                             f"expected one")
    return result, taken[0]


def rglru_checks(call, ref, rl, gen) -> list:
    """``call(a, b, h0)`` (the RG-LRU kernel through its wrapper) against
    the plain version, bit for bit (int32 / int16 views), on RGLRU_SHAPES
    and RGLRU_OFFSET_CASE, f32 and bf16, with and without h0; raises on a
    difference, or unless both routes were launched in both dtypes."""
    import torch

    dev = torch.device(DEVICE)
    cases = [(shape, 0) for shape in RGLRU_SHAPES] + [RGLRU_OFFSET_CASE]
    checks = []
    for (b, t, d), offset in cases:
        for dtype in ("float32", "bfloat16"):
            tdt = _tdtype(dtype)
            skip = offset // tdt.itemsize
            buf = torch.empty(skip + b * t * d, dtype=tdt, device=dev)
            a = buf[skip:].view(b, t, d)
            a.copy_(torch.rand((b, t, d), generator=gen, device=dev) * 0.79
                    + 0.2)
            x = torch.randn((b, t, d), generator=gen, device=dev).to(tdt)
            h0 = torch.randn((b, d), generator=gen, device=dev).to(tdt)
            bits = torch.int16 if dtype == "bfloat16" else torch.int32
            for hh in (None, h0):
                got, which = rglru_route_taken(rl, lambda: call(a, x, hh))
                want = ref.ref_rg_lru(a, x, hh)
                torch.cuda.synchronize()
                if not torch.equal(got.view(bits), want.view(bits)):
                    raise AssertionError(
                        f"rg_lru kernel != plain version at {(b, t, d)} "
                        f"{dtype} offset {offset} B h0={hh is not None} "
                        f"({which} route)")
                checks.append(dict(shape=[b, t, d], dtype=dtype,
                                   offset_bytes=offset, route=which,
                                   h0=hh is not None, bitwise=True))
            del buf, a, x, h0, got, want
    taken = {(c["dtype"], c["route"]) for c in checks}
    if len(taken) != 4:
        raise AssertionError(f"RG-LRU checks took only {sorted(taken)}")
    return checks


def rglru_attributes(rl) -> dict:
    """Registers, spills, static and dynamic shared memory of every RG-LRU
    specialization, from the runtime; raises if any of them spills."""
    attrs = {f"{dt}_{which}": rl.kernel_attributes(_tdtype(dt), which)
             for dt in ("float32", "bfloat16") for which in rl.ROUTES}
    spilled = {key: a for key, a in attrs.items() if a["local_bytes"]}
    if spilled:
        raise AssertionError(f"rg_lru specializations with local memory "
                             f"(spills): {spilled}")
    return attrs


def rglru_units(rl, b, d, dtype) -> dict:
    """The kernel's units at [b, *, d] and how evenly they spread over the
    card's SMs: the mean per SM over the busiest SM's count."""
    import torch

    n = len(rl.units(b, d, dtype))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    busiest = -(-n // sms)
    return dict(units=n, sms=sms, busiest_sm_units=busiest,
                balance=n / sms / busiest)


def rglru_caller(rl, lib):
    """A function (a, b, h0) -> h that runs ``lib``'s kernel through the
    wrapper, counted as the wrapper counts."""
    def call(a, x, h0=None):
        saved, rl.LIBRARY = rl.LIBRARY, lib
        try:
            return rl.rg_lru(a, x, h0)
        finally:
            rl.LIBRARY = saved
    return call


def probe_rg_lru(rl, ref, sources) -> dict:
    """``--probe rg_lru``: build the kernels, hold the checkout's RG-LRU
    kernel and each of ``sources`` (other ``rg_lru.cu`` files of the same C
    interface: ``rg_lru_launch``, ``rg_lru_route``) bit for bit to the plain
    version, and time the serve shape back to back in turns on this card,
    beside the copy yardstick."""
    from pathlib import Path

    import torch
    from repro_torch.kernels import build

    libs = {"checkout": rl.LIBRARY}
    for i, path in enumerate(sources):
        lib = build.KernelLibrary(f"rg_lru_probe{i}", rl._bind)
        lib.source = Path(path).resolve()
        libs[path] = lib
    phase_device(list(libs.values()))
    calls = {name: rglru_caller(rl, lib) for name, lib in libs.items()}
    gen = torch.Generator(device=DEVICE)
    out = {name: {"back_to_back_ms": []} for name in libs}
    for name, call in calls.items():
        gen.manual_seed(12)
        out[name]["checks"] = len(rglru_checks(call, ref, rl, gen))
    out["checkout"]["attributes"] = rglru_attributes(rl)

    b, t, d = RGLRU_SHAPES[0]
    a = torch.rand((b, t, d), generator=gen, device=DEVICE) * 0.79 + 0.2
    x = torch.randn((b, t, d), generator=gen, device=DEVICE)
    yardstick = [back_to_back_ms(lambda: torch.add(a, x), 20)]
    for name in list(sources) + ["checkout"] * 2 + list(sources)[::-1]:
        out[name]["back_to_back_ms"].append(back_to_back_ms(
            lambda: calls[name](a, x), 20))
    yardstick.append(back_to_back_ms(lambda: torch.add(a, x), 20))
    b_ms, b_by, nbytes = rglru_bound(b, t, d)
    emit("probe_rg_lru", shape=[b, t, d], bound_ms=b_ms, bound_by=b_by,
         bytes=nbytes, copy_yardstick_ms=yardstick,
         units=rglru_units(rl, b, d, torch.float32), sources=out)
    return out


def rglru_bound(b, t, d, elt=4):
    """a and b read once, h written once; a multiply and an add each."""
    nbytes = 3 * elt * b * t * d
    t_ops, t_bytes = 2 * b * t * d / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def phase_lm_kernels(fa, rl, ref) -> dict:
    """Both serving kernels against their plain versions on the card, then
    timed at the serve shape beside their plain versions and SDPA."""
    import torch

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    # RG-LRU: bit for bit, every case, both routes
    rg_checks = rglru_checks(rl.rg_lru, ref, rl, gen)

    fl_checks = flash_checks(fa, ref, gen)

    # timing at the serve shape
    b, t, s, h, kv, dh, causal, window, _, _ = SERVE_FLASH_CASE
    q, k, v = flash_operands(SERVE_FLASH_CASE, gen)
    qpos = torch.arange(t, device=dev)[:, None]
    kpos = torch.arange(s, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)

    kern = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                      window=window)
    plain = lambda: ref.ref_attention(q, k, v, causal=causal,  # noqa: E731
                                      window=window)
    want = plain()
    backends = sdpa_backends(q, k, v, mask, want)
    del want
    fastest = min((r for r in backends if r["accepted"]),
                  key=lambda r: r["ms"])
    b_ms, b_by, flop, nbytes = flash_bound(b, t, s, h, kv, dh, causal,
                                           window)
    flash = dict(shape=[b, t, s, h, kv, dh], window=window,
                 ms=event_ms(kern, 10), plain_ms=event_ms(plain, 3),
                 back_to_back_ms=back_to_back_ms(kern, 5),
                 plain_back_to_back_ms=back_to_back_ms(plain, 3),
                 library_ms=fastest["ms"],
                 library_back_to_back_ms=fastest["back_to_back_ms"],
                 library_max_abs_err=fastest["max_abs_err"],
                 library="torch.nn.functional.scaled_dot_product_attention "
                         f"(bool mask, {fastest['backend']} backend, "
                         f"{fastest['kv']})",
                 sdpa_backends=backends,
                 bound_ms=b_ms, bound_by=b_by,
                 split_tf32_floor_ms=split_tf32_floor_ms(flop),
                 flop=flop, bytes=nbytes,
                 max_abs_err=next(c["max_abs_err"] for c in fl_checks
                                  if c["case"] == list(SERVE_FLASH_CASE)),
                 attributes=flash_attributes(fa))
    flash["tflop_per_s"] = flop / (flash["back_to_back_ms"] * 1e-3) / 1e12
    del q, k, v, mask
    flash["family_shapes"] = family_flash_times(fa, ref, gen, fl_checks)

    b, t, d = RGLRU_SHAPES[0]
    a = torch.rand((b, t, d), generator=gen, device=dev) * 0.79 + 0.2
    x = torch.randn((b, t, d), generator=gen, device=dev)
    kern = lambda: rl.rg_lru(a, x)                              # noqa: E731
    plain = lambda: ref.ref_rg_lru(a, x)                        # noqa: E731
    # the achievable rate for the same bytes (two reads, one write): not a
    # library_ms, since add computes another function
    yardstick = lambda: torch.add(a, x)                         # noqa: E731
    b_ms, b_by, nbytes = rglru_bound(b, t, d)
    ms, which = rglru_route_taken(rl, lambda: event_ms(kern, 20))
    rglru = dict(shape=[b, t, d], ms=ms, plain_ms=event_ms(plain, 3),
                 back_to_back_ms=back_to_back_ms(kern, 20),
                 plain_back_to_back_ms=back_to_back_ms(plain, 2),
                 copy_yardstick_ms=back_to_back_ms(yardstick, 20),
                 bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=0.0,
                 library_ms=None,
                 route=which,
                 attributes=rglru_attributes(rl),
                 **rglru_units(rl, b, d, a.dtype))
    rglru["gbytes_per_s"] = nbytes / (rglru["back_to_back_ms"] * 1e-3) / 1e9
    rglru["copy_yardstick_gbytes_per_s"] = (
        nbytes / (rglru["copy_yardstick_ms"] * 1e-3) / 1e9)
    del a, x
    torch.cuda.empty_cache()
    out = dict(rg_lru_checks=rg_checks, flash_checks=fl_checks,
               flash_f32_max_abs_err=max(c["max_abs_err"] for c in fl_checks
                                         if c["tol"] == FLASH_TOL["float32"]),
               flash_bf16_max_abs_err=max(c["max_abs_err"] for c in fl_checks
                                          if c["tol"] == FLASH_TOL["bfloat16"]),
               flash=flash, rg_lru=rglru)
    emit("lm_kernels", **out)
    return out


def family_flash_times(fa, ref, gen, checks: list) -> dict:
    """The families' flash shapes (FAMILY_FLASH_CASES, held within
    FLASH_TOL by `flash_checks`): kernel, plain-version and SDPA (its
    fastest backend that takes the case) call times beside the bound."""
    import torch

    out = {}
    for name, case in FAMILY_FLASH_CASES.items():
        b, t, s, h, kv, dh, causal, window, _, _ = case
        q, k, v = flash_operands(case, gen)
        b_ms, b_by, flop, nbytes = flash_bound(b, t, s, h, kv, dh, causal,
                                               window)
        mask = (torch.ones((t, s), dtype=torch.bool, device=q.device).tril()
                if causal else None)
        want = ref.ref_attention(q, k, v, causal=causal)
        backends = sdpa_backends(q, k, v, mask, want)
        del want, mask
        fastest = min((r for r in backends if r["accepted"]),
                      key=lambda r: r["ms"])
        out[name] = dict(
            library_ms=fastest["ms"],
            library=f"scaled_dot_product_attention ({fastest['backend']} "
                    f"backend, {fastest['kv']})",
            library_max_abs_err=fastest["max_abs_err"],
            shape=[b, t, s, h, kv, dh], causal=causal,
            ms=event_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                        10),
            plain_ms=event_ms(lambda: ref.ref_attention(q, k, v,
                                                        causal=causal), 3),
            bound_ms=b_ms, bound_by=b_by, flop=flop, bytes=nbytes,
            split_tf32_floor_ms=split_tf32_floor_ms(flop),
            max_abs_err=next(c["max_abs_err"] for c in checks
                             if c["case"] == list(case)))
        del q, k, v
    return out


def _rel_diff(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return diff, diff / scale if scale > 0 else diff


def profile_top(fn, keys: tuple = (), n: int = 8, host: bool = True) -> dict:
    """One profiled call of ``fn``: wall time, device busy time, its share,
    the kernels that took the most device time, and for each of ``keys``
    the launches and device time of the kernels whose names hold it.
    ``host=False`` traces the device alone (none of these figures needs
    the host's ops, and a call of ~10^5 launches costs minutes to sum
    with them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    rows = device_rows(prof)
    busy_us = sum(_device_us(e) for e in rows)
    top = sorted(rows, key=_device_us, reverse=True)[:n]
    kernels = {}
    for key in keys:
        mine = [e for e in rows if key in e.key]
        kernels[key] = dict(count=sum(e.count for e in mine),
                            device_ms=sum(_device_us(e) for e in mine) * 1e-3)
    return dict(wall_ms=wall_s * 1e3, device_busy_ms=busy_us * 1e-3,
                busy_share=busy_us / (wall_s * 1e6),
                device_launches=sum(e.count for e in rows), kernels=kernels,
                top=[dict(name=e.key[:70], count=e.count,
                          device_ms=_device_us(e) * 1e-3) for e in top])


def phase_serve(fa, rl, kern) -> dict:
    """recurrentgemma-2b served at full width through the kernels, counted;
    then the same prompt through the plain path, compared."""
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.train import make_decode_step

    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCH_COUNT = rl.LAUNCH_COUNT = ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    t0 = time.time()
    out = serve(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                new_tokens=SERVE_NEW, preset="full", seed=0)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(flash_attention=fa.LAUNCH_COUNT, rg_lru=rl.LAUNCH_COUNT,
                    mltcp_step=ms.LAUNCH_COUNT, netsim_chunk=nc.LAUNCH_COUNT,
                    fallbacks=ops.FALLBACK_COUNT + ops.CHUNK_FALLBACK_COUNT)
    cfg, model, req = out["cfg"], out["model"], out["request"]
    kinds = [blk.kind for blk in model.layers]
    want = dict(flash_attention=kinds.count("attn_local") + kinds.count("attn"),
                rg_lru=kinds.count("rec"), mltcp_step=0, netsim_chunk=0,
                fallbacks=0)
    if launches != want or want["flash_attention"] != 8 or want["rg_lru"] != 18:
        raise AssertionError(f"serve launches {launches}, expected {want} "
                             f"(8 flash, 18 RG-LRU per prefill)")
    gen_ids = out["generated"]
    if (tuple(gen_ids.shape) != (SERVE_BATCH, SERVE_NEW)
            or int(gen_ids.min()) < 0
            or int(gen_ids.max()) >= cfg.vocab_padded):
        raise AssertionError(f"generated ids {tuple(gen_ids.shape)} out of "
                             f"range")
    n_params = sum(p.numel() for p in model.parameters())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same prompt, kernel path vs plain path; the kernel path is the
    # API's default on the card (no use_kernel), counted
    fa.LAUNCH_COUNT = rl.LAUNCH_COUNT = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.time()
        logits_k, cache_k = api.prefill(cfg, model, req, out["max_len"])
        torch.cuda.synchronize()
        warm_prefill_s = time.time() - t1
        default_launches = dict(flash_attention=fa.LAUNCH_COUNT,
                                rg_lru=rl.LAUNCH_COUNT)
        if default_launches != {k: want[k] for k in default_launches}:
            raise AssertionError(f"api.prefill with no use_kernel launched "
                                 f"{default_launches}, expected {want}")
        t1 = time.time()
        logits_p, cache_p = api.prefill(cfg, model, req, out["max_len"],
                                        use_kernel=False)
        torch.cuda.synchronize()
        plain_prefill_s = time.time() - t1
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits")
    logit_abs, logit_rel = _rel_diff(logits_k, logits_p)
    cache_diffs = {}
    for i, entry in cache_p.items():
        for name, tensor in entry.items():
            if name == "pos":
                if not torch.equal(cache_k[i][name], tensor):
                    raise AssertionError(f"ring positions differ, layer {i}")
                continue
            cache_diffs[f"{i}.{name}"] = _rel_diff(cache_k[i][name], tensor)
    worst_cache = max(cache_diffs.items(), key=lambda kv: kv[1][1])
    if logit_rel > SERVE_REL_BOUND or worst_cache[1][1] > SERVE_REL_BOUND:
        raise AssertionError(f"kernel vs plain prefill: logits {logit_rel}, "
                             f"cache {worst_cache} over {SERVE_REL_BOUND}")
    top2 = torch.topk(logits_p.float(), 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decisive = gap > 10 * logit_abs
    same = torch.argmax(logits_k, -1) == torch.argmax(logits_p, -1)
    if not bool(same[decisive].all()):
        raise AssertionError(f"first greedy token differs in a row whose "
                             f"top-2 gap exceeds 10x the logit difference")
    if not torch.equal(gen_ids[:, 0].long(), torch.argmax(logits_k, -1)):
        raise AssertionError("serve's first token is not the prefill argmax")
    del logits_p, cache_p
    torch.cuda.empty_cache()

    # where the time goes: one profiled prefill and three decode steps
    def one_prefill():
        with torch.no_grad():
            api.prefill(cfg, model, req, out["max_len"], use_kernel=True)
    prefill_prof = profile_top(one_prefill, ("flash_kernel", "rg_lru_kernel"))
    traced = prefill_prof["kernels"]
    prefill_prof["complete"] = (
        traced["flash_kernel"]["count"] == want["flash_attention"]
        and traced["rg_lru_kernel"]["count"] == want["rg_lru"])
    tok = gen_ids[:, 0]
    pos0 = SERVE_PROMPT

    def three_steps():
        with torch.no_grad():
            for i in range(3):
                api.decode_step(cfg, model, cache_k, tok, pos0 + i)
    decode_prof = profile_top(three_steps)

    # warm decode: serve's decode step, SERVE_NEW - 1 steps from the
    # prefill's cache, DECODE_TURNS times (serve's own figure is its first
    # call's, which pays one-time host costs)
    decode = make_decode_step(cfg)
    turn_s = []
    with torch.no_grad():
        for _ in range(DECODE_TURNS):
            torch.cuda.synchronize()
            t1 = time.time()
            step_tok, cache = tok, cache_k
            for i in range(SERVE_NEW - 1):
                step_tok, cache = decode(model, cache, step_tok, pos0 + i)
            torch.cuda.synchronize()
            turn_s.append(time.time() - t1)
    del cache
    warm_rates = [SERVE_BATCH * (SERVE_NEW - 1) / t for t in turn_s]
    per_launch = {key: (v["device_ms"] / v["count"] if v["count"] else None)
                  for key, v in traced.items()}
    del cache_k, logits_k

    res = dict(
        arch=SERVE_ARCH, preset="full", batch=SERVE_BATCH,
        prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW, seed=0,
        params=n_params, param_gb=n_params * 4 / 1e9, launches=launches,
        default_prefill_launches=default_launches,
        seconds_total=seconds, prefill_ms=out["prefill_s"] * 1e3,
        warm_prefill_ms=warm_prefill_s * 1e3,
        plain_prefill_ms=plain_prefill_s * 1e3,
        decode_ms_per_step=out["decode_s"] * 1e3 / (SERVE_NEW - 1),
        decode_tok_per_s=out["decode_tok_per_s"],
        warm_decode_tok_per_s=statistics.median(warm_rates),
        warm_decode_tok_per_s_turns=warm_rates,
        prefill_tok_per_s=SERVE_BATCH * SERVE_PROMPT / out["prefill_s"],
        peak_memory_gb=peak_gb,
        logits_max_abs_diff=logit_abs, logits_max_rel_diff=logit_rel,
        cache_worst=dict(tensor=worst_cache[0], max_abs_diff=worst_cache[1][0],
                         max_rel_diff=worst_cache[1][1]),
        cache_max_abs_diff=max(d[0] for d in cache_diffs.values()),
        rel_bound=SERVE_REL_BOUND,
        first_token_rows_decisive=int(decisive.sum()),
        first_token_same=[bool(x) for x in same],
        generated_first_row=[int(x) for x in gen_ids[0]],
        path_device_ms_per_launch=per_launch,
        prefill_profile=prefill_prof, decode3_profile=decode_prof)
    del out, model
    torch.cuda.empty_cache()
    emit("serve_main_path", **res)
    return res


# ---------------------------------------------------------------------------
# training: the kernels' backward passes, the training step, resume
# ---------------------------------------------------------------------------

TRAIN_ARCH = "recurrentgemma-2b"
# 1 x 4096 tokens: beyond the 2048-token window, so the local mask works
TRAIN_BATCH, TRAIN_SEQ = 1, 4096
# step 0 is the first (allocator and kernel warm-up); steps TRAIN_WARM_FROM
# .. TRAIN_STEPS - 1 are the warm window whose spread the step time's
# bound has to stand on
TRAIN_STEPS, TRAIN_WARM_FROM = 8, 2
# per step with remat: 8 groups of (rec, rec, attn_local) and 2 tail rec
# blocks; flash: 8 forward + 8 recomputed; RG-LRU: 18 forward + 16
# recomputed + 18 reverse scans
TRAIN_LAUNCHES_PER_STEP = {"flash_attention": 16, "rg_lru": 52}
# the dense attention's VJP per flash layer in the backward pass
TRAIN_FLASH_VJPS_PER_STEP = 8
TRAIN_DEPTH_CUT_LAYERS = 3            # one group of block_pattern
TRAIN_REL_BOUND = SERVE_REL_BOUND     # kernel path vs plain path
RESUME_STEPS, RESUME_AT, RESUME_SEQ, RESUME_BATCH = 4, 2, 64, 2
RESUME_BOUND = 1e-6
# (B, T, D, dtype, h0, offset bytes of a): the training shape, bf16, a
# ragged D (general route), an operand 4 bytes off, T = 1, h0
RGLRU_GRAD_CASES = [
    (TRAIN_BATCH, TRAIN_SEQ, 2560, "float32", False, 0),
    (TRAIN_BATCH, TRAIN_SEQ, 2560, "float32", True, 0),
    (2, 77, 136, "bfloat16", True, 0),
    (3, 33, 130, "float32", True, 0),
    (2, 70, 256, "float32", False, 4),
    (2, 1, 2560, "float32", True, 0),
    (2, 1, 2560, "bfloat16", False, 0),
]
TRAIN_FLASH_CASE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 10, 1, 256, True,
                    2048, None, "float32")
FLASH_GRAD_CASES = [TRAIN_FLASH_CASE,
                    (2, 100, 100, 4, 2, 64, True, 0, 50.0, "float32"),
                    (1, 77, 77, 2, 1, 64, True, 16, None, "bfloat16")]


def grad_checks(fa, rl, ref, gen) -> dict:
    """(a) The kernels' backward passes on the card: the RG-LRU reverse
    scan's (da, db, dh0) equal autograd through the sequential plain loop
    bit for bit.  Flash's backward is the dense attention's VJP itself, so
    its gradients' equality with autograd through ``ref_attention`` checks
    only the plumbing (saved operands, options, dtypes); the kernel is held
    by its forward output in the same case, within FLASH_TOL of
    ``ref_attention``.  Raises otherwise.  Times both backward passes at
    the training shape."""
    import torch

    rg = []
    for b, t, d, dtype, with_h0, offset in RGLRU_GRAD_CASES:
        tdt = _tdtype(dtype)
        skip = offset // tdt.itemsize
        a = torch.empty(skip + b * t * d, dtype=tdt, device=DEVICE
                        )[skip:].view(b, t, d)
        a.copy_(torch.rand((b, t, d), generator=gen, device=DEVICE) * 0.79
                + 0.2)
        x, g = (torch.randn((b, t, d), generator=gen, device=DEVICE).to(tdt)
                for _ in range(2))
        ins = [a, x] + ([torch.randn((b, d), generator=gen, device=DEVICE
                                     ).to(tdt)] if with_h0 else [])
        mine = [v.detach().requires_grad_(True) for v in ins]
        before = rl.LAUNCH_COUNT
        got = torch.autograd.grad(rl.rg_lru(*mine), mine, g)
        launches = rl.LAUNCH_COUNT - before
        theirs = [v.detach().clone().requires_grad_(True) for v in ins]
        want = torch.autograd.grad(ref.ref_rg_lru(*theirs), theirs, g)
        torch.cuda.synchronize()
        # torch.equal: autograd's sum over the slices of a turns da_0 =
        # gh_0 * 0 into +0 where the reverse scan's product keeps -0
        for name, x_got, x_want in zip(("da", "db", "dh0"), got, want):
            if not torch.equal(x_got, x_want):
                raise AssertionError(f"rg_lru backward {name} != autograd "
                                     f"through the plain loop at "
                                     f"{(b, t, d)} {dtype} h0={with_h0}")
        if launches != 2:
            raise AssertionError(f"rg_lru forward + backward launched "
                                 f"{launches}, expected 2")
        rg.append(dict(shape=[b, t, d], dtype=dtype, h0=with_h0,
                       offset_bytes=offset, bitwise=True, launches=launches))
        del a, x, g, ins, mine, theirs, got, want

    fl = []
    for case in FLASH_GRAD_CASES:
        *_, causal, window, cap, dtype = case
        q, k, v = flash_operands(case, gen)
        g = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
        opts = dict(causal=causal, window=window, softcap=cap)
        mine = [x.detach().requires_grad_(True) for x in (q, k, v)]
        before = fa.LAUNCH_COUNT
        out = fa.flash_attention(*mine, **opts)
        got = torch.autograd.grad(out, mine, g)
        launches = fa.LAUNCH_COUNT - before
        theirs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        ref_out = ref.ref_attention(*theirs, **opts)
        want = torch.autograd.grad(ref_out, theirs, g)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        out, ref_out = out.detach().float(), ref_out.detach().float()
        fwd_err = float((out - ref_out).abs().max())
        if not torch.allclose(out, ref_out, atol=tol, rtol=tol):
            raise AssertionError(f"flash forward vs ref_attention outside "
                                 f"{tol} at {case}: max |diff| {fwd_err}")
        for name, x_got, x_want in zip("qkv", got, want):
            if not torch.equal(x_got, x_want):
                err = float((x_got.float() - x_want.float()).abs().max())
                raise AssertionError(f"flash backward d{name} != autograd "
                                     f"through ref_attention at {case}: "
                                     f"max |diff| {err}")
        if launches != 1:
            raise AssertionError(f"flash forward + backward launched "
                                 f"{launches}, expected 1")
        fl.append(dict(case=list(case), forward_max_abs_err=fwd_err,
                       forward_tol=tol, backward_equals_dense_vjp=True,
                       launches=launches))
        del q, k, v, g, mine, theirs, out, ref_out, got, want

    # the backward passes' times at the training shape, beside their bounds
    b, t, d = TRAIN_BATCH, TRAIN_SEQ, 2560
    a = torch.rand((b, t, d), generator=gen, device=DEVICE) * 0.79 + 0.2
    x, g = (torch.randn((b, t, d), generator=gen, device=DEVICE)
            for _ in range(2))
    ar = a.requires_grad_(True)
    h = rl.rg_lru(ar, x.requires_grad_(True))
    backward = lambda: torch.autograd.grad(  # noqa: E731
        h, (ar, x), g, retain_graph=True)
    scan_only = lambda: rl.reverse_scan(a, g)  # noqa: E731
    scan_b_ms, scan_b_by, scan_bytes = rglru_bound(b, t, d)
    # the backward reads a, h and g and writes da and db
    bwd_bytes = 5 * 4 * b * t * d
    rg_timing = dict(
        shape=[b, t, d], backward_ms=event_ms(backward, 10),
        reverse_scan_ms=event_ms(scan_only, 10),
        reverse_scan_device_ms=device_ms(scan_only, 10),
        backward_bound_ms=1e3 * bwd_bytes / HBM_BYTES_PER_S,
        backward_bytes=bwd_bytes, scan_bound_ms=scan_b_ms,
        scan_bound_by=scan_b_by, scan_bytes=scan_bytes,
        plain_backward_ms=None)
    theirs = [v.detach().clone().requires_grad_(True) for v in (a, x)]
    h_plain = ref.ref_rg_lru(*theirs)
    rg_timing["plain_backward_ms"] = event_ms(
        lambda: torch.autograd.grad(h_plain, theirs, g, retain_graph=True),
        2, warm=1)
    del a, x, g, ar, h, theirs, h_plain

    bq, tq, s, hq, kv, dh, causal, window, _, _ = TRAIN_FLASH_CASE
    q, k, v = flash_operands(TRAIN_FLASH_CASE, gen)
    gq = torch.randn(q.shape, generator=gen, device=DEVICE)
    mine = [z.requires_grad_(True) for z in (q, k, v)]
    out = fa.flash_attention(*mine, causal=causal, window=window)
    f_b_ms, f_b_by, flop, nbytes = flash_bound(bq, tq, s, hq, kv, dh, causal,
                                               window)
    # the backward of the same masked pairs: s = q.k recomputed, dp = do.v,
    # dv = p^T do, dq = ds k, dk = ds^T q: 5 products against the forward's
    # 2; q, k, v, o and do read, dq, dk and dv written
    bwd_flop = flop * 5 // 2
    bwd_bytes = 4 * (4 * bq * tq * hq * dh + 4 * bq * s * kv * dh)
    fl_timing = dict(
        shape=[bq, tq, s, hq, kv, dh], window=window,
        dense_vjp_ms=event_ms(lambda: torch.autograd.grad(
            out, mine, gq, retain_graph=True), 5),
        forward_ms=event_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window), 5),
        backward_flop=bwd_flop, backward_bytes=bwd_bytes,
        backward_bound_ms=1e3 * max(bwd_flop / F32_OPS_PER_S,
                                    bwd_bytes / HBM_BYTES_PER_S),
        backward_bound_by=("operations" if bwd_flop / F32_OPS_PER_S
                           >= bwd_bytes / HBM_BYTES_PER_S else "bytes"),
        route="dense VJP of ref_attention (torch ops), as the reference's "
              "custom_vjp")
    del q, k, v, gq, mine, out
    torch.cuda.empty_cache()
    return dict(rg_lru_checks=rg, flash_checks=fl, rg_lru=rg_timing,
                flash=fl_timing)


def _grad_rel(got: dict, want: dict) -> tuple[str, float]:
    """The leaf with the largest max |got - want| over its max |want|."""
    worst = ("", 0.0)
    for name, w in want.items():
        scale = float(w.abs().max()) or 1.0
        rel = float((got[name] - w).abs().max()) / scale
        worst = max(worst, (name, rel), key=lambda x: x[1])
    return worst


def depth_cut_check(fa, rl) -> dict:
    """(b) recurrentgemma-2b at full width cut to one group of its pattern
    (3 blocks), T = 4096: the loss and every gradient on the kernel path
    (the API's default on the card) against the plain path."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.train import TrainHyper, init_train_state, loss_fn

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_DEPTH_CUT_LAYERS)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    state = init_train_state(cfg, TrainHyper(), gen, DEVICE)
    batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH), 0, DEVICE)
    params = dict(state.model.named_parameters())
    out = {}
    for label, use_kernel in (("kernel", None), ("plain", False)):
        before = (fa.LAUNCH_COUNT, rl.LAUNCH_COUNT)
        loss, _ = loss_fn(cfg, state.model, batch,
                          TrainHyper(use_kernel=use_kernel))
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        out[label] = (float(loss.detach()), dict(zip(params, grads)),
                      (fa.LAUNCH_COUNT - before[0],
                       rl.LAUNCH_COUNT - before[1]))
        del loss, grads
    (lk, gk, nk), (lp, gp, np_) = out["kernel"], out["plain"]
    # one group: flash 1 + 1 recomputed; RG-LRU 2 + 2 recomputed + 2 reverse
    if nk != (2, 6) or np_ != (0, 0):
        raise AssertionError(f"depth-cut launches kernel {nk}, plain {np_}: "
                             f"expected (2, 6) and (0, 0)")
    loss_rel = abs(lk - lp) / abs(lp)
    worst = _grad_rel(gk, gp)
    if not (loss_rel <= TRAIN_REL_BOUND and worst[1] <= TRAIN_REL_BOUND):
        raise AssertionError(f"depth-cut kernel vs plain: loss {loss_rel}, "
                             f"gradient {worst} over {TRAIN_REL_BOUND}")
    if not all(bool(torch.isfinite(g).all()) for g in gk.values()):
        raise AssertionError("non-finite gradient on the kernel path")
    del out, gk, gp, state, params, batch
    torch.cuda.empty_cache()
    return dict(layers=TRAIN_DEPTH_CUT_LAYERS, seq=TRAIN_SEQ,
                loss_kernel=lk, loss_plain=lp, loss_rel_diff=loss_rel,
                worst_grad=dict(leaf=worst[0], rel_diff=worst[1]),
                rel_bound=TRAIN_REL_BOUND, launches_kernel=list(nk))


def plain_calls():
    """Count the model's plain paths (`attention.attend`,
    `rglru.scan_rg_lru`) and the kernels' plain versions as the wrappers
    reach them (`ref_rg_lru`, `ref_attention`: the latter only as flash's
    backward VJP on the card); returns (counts, undo)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.models import attention, rglru

    counts = {}
    saved = []
    for mod, name in ((attention, "attend"), (rglru, "scan_rg_lru"),
                      (rl, "ref_rg_lru"), (fa, "ref_attention")):
        fn = getattr(mod, name)
        counts[name] = 0

        def wrapped(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)
        setattr(mod, name, wrapped)
        saved.append((mod, name, fn))

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return counts, undo


def resume_check() -> dict:
    """(d) Checkpoint and resume on the card at the smoke preset: training
    to step 4 straight against training to 2, saving, and resuming to 4,
    compared at step 4's loss.  Deterministic algorithms are on for this
    check: the embedding's backward (an indexed accumulate) otherwise
    sums with atomics, in an order that changes from run to run."""
    import shutil

    import torch

    from repro_torch.launch.train import train

    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(steps=RESUME_STEPS, seq_len=RESUME_SEQ, batch=RESUME_BATCH,
              preset="smoke", log_every=1000)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            straight = train(TRAIN_ARCH, **kw)
            first = train(TRAIN_ARCH, **dict(kw, steps=RESUME_AT),
                          ckpt_dir=ckpt, ckpt_every=RESUME_AT)
            resumed = train(TRAIN_ARCH, **kw, ckpt_dir=ckpt, resume=True)
    finally:
        torch.use_deterministic_algorithms(False)
    shutil.rmtree(ckpt, ignore_errors=True)
    diff = abs(resumed["losses"][-1] - straight["losses"][-1])
    if resumed["steps"] != RESUME_STEPS - RESUME_AT or diff >= RESUME_BOUND:
        raise AssertionError(f"resumed loss at step {RESUME_STEPS} differs by "
                             f"{diff} (bound {RESUME_BOUND}), "
                             f"{resumed['steps']} steps run")
    if first["losses"] != straight["losses"][:RESUME_AT]:
        raise AssertionError("the first two steps differ between two runs")
    return dict(steps=RESUME_STEPS, saved_at=RESUME_AT, seq=RESUME_SEQ,
                batch=RESUME_BATCH, straight_losses=straight["losses"],
                resumed_losses=resumed["losses"], loss_abs_diff=diff,
                bound=RESUME_BOUND, deterministic_algorithms=True)


def phase_train(fa, rl, ref, kern) -> dict:
    """Training on the card: (a) the backward checks, (b) the depth-cut
    kernel path against the plain path, (c) recurrentgemma-2b at full
    width and depth, TRAIN_STEPS steps through ``launch.train``, counted
    and profiled, (d) checkpoint and resume."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.train import train
    from repro_torch.train import (TrainHyper, init_train_state,
                                   make_train_step)

    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(21)
    grads = grad_checks(fa, rl, ref, gen)
    depth_cut = depth_cut_check(fa, rl)

    # (c) the main path of this slice: counts to 0 just before, read after
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain, undo = plain_calls()
    fa.LAUNCH_COUNT = rl.LAUNCH_COUNT = ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    t0 = time.time()
    try:
        out = train(TRAIN_ARCH, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                    batch=TRAIN_BATCH, preset="full", seed=0, log_every=1)
        torch.cuda.synchronize()
    finally:
        undo()
    seconds = time.time() - t0
    launches = dict(flash_attention=fa.LAUNCH_COUNT, rg_lru=rl.LAUNCH_COUNT,
                    mltcp_step=ms.LAUNCH_COUNT, netsim_chunk=nc.LAUNCH_COUNT,
                    fallbacks=ops.FALLBACK_COUNT + ops.CHUNK_FALLBACK_COUNT)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: TRAIN_STEPS * n for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
    want.update(mltcp_step=0, netsim_chunk=0, fallbacks=0)
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    want_plain = dict(attend=0, scan_rg_lru=0, ref_rg_lru=0,
                      ref_attention=TRAIN_STEPS * TRAIN_FLASH_VJPS_PER_STEP)
    if plain != want_plain:
        raise AssertionError(f"plain-path calls {plain}, expected "
                             f"{want_plain}")
    finite = all(map(math.isfinite, out["losses"] + out["grad_norms"]))
    if not finite or out["steps"] != TRAIN_STEPS:
        raise AssertionError(f"training gave losses {out['losses']}, "
                             f"gradient norms {out['grad_norms']}")
    cfg = get_config(TRAIN_ARCH)
    step_ms = [s * 1e3 for s in out["step_s"]]
    warm = step_ms[TRAIN_WARM_FROM:]
    warm_ms = statistics.median(warm)

    # where a warm step's time goes: a fresh state, one step, one profiled
    hyper = TrainHyper(warmup=max(TRAIN_STEPS // 20, 5),
                       total_steps=TRAIN_STEPS)
    gen.manual_seed(0)
    state = init_train_state(cfg, hyper, gen, DEVICE)
    n_params = sum(p.numel() for p in state.model.parameters())
    step_fn = make_train_step(cfg, hyper)
    batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH), 0, DEVICE)
    box = {"state": step_fn(state, batch)[0]}
    del state

    def one_step():
        box["state"] = step_fn(box["state"], batch)[0]
    prof = profile_top(one_step, ("flash_kernel", "rg_lru_kernel"), n=10)
    del box
    torch.cuda.empty_cache()

    resume = resume_check()
    res = dict(
        arch=TRAIN_ARCH, preset="full", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, seed=0, params=n_params,
        param_gb=n_params * 4 / 1e9, dtype="float32", remat=True,
        launches=launches,
        launches_per_step={k: launches[k] / TRAIN_STEPS
                           for k in TRAIN_LAUNCHES_PER_STEP},
        plain_calls=plain, seconds_total=seconds, step_ms=step_ms,
        first_step_ms=step_ms[0], warm_from_step=TRAIN_WARM_FROM,
        warm_step_ms=warm_ms, warm_step_min_ms=min(warm),
        warm_step_max_ms=max(warm),
        warm_step_spread=(max(warm) - min(warm)) / warm_ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (warm_ms * 1e-3),
        peak_memory_gb=peak_gb, losses=out["losses"],
        grad_norms=out["grad_norms"], warm_step_profile=prof,
        depth_cut=depth_cut, grad_checks=grads, resume=resume)
    emit("train_main_path", **res)
    return res


# ---------------------------------------------------------------------------
# the MoE, xLSTM and encoder-decoder families served at full width
# ---------------------------------------------------------------------------

# (arch, batch, prompt tokens, new tokens, flash launches a prefill): one
# model of each family at its full published widths and depth, random
# weights from seed 0; deepseek's 28 causal layers, seamless's 12
# bidirectional encoder and 12 causal decoder self-attention layers
# (cross-attention takes no kernel), xlstm none
SERVE_FAMILIES = (("deepseek-moe-16b", 1, 4096, 16, 28),
                  ("xlstm-125m", 4, 4096, 16, 0),
                  ("seamless-m4t-medium", 4, 4096, 16, 24))
FAMILY_DECODE_TURNS = 3


class RoutingLog:
    """Wraps ``moe.route`` while active: records each call's top-k choices
    and the smallest top-k margin per token; in replay mode, routes every
    call as the recorded run did (the same experts, weights from this
    run's probabilities)."""

    def __init__(self, moe):
        self.moe, self.real = moe, moe.route
        self.calls, self.replay = [], None

    def __enter__(self):
        self.calls = []
        moe = self.moe

        def route(params, cfg, xf):
            probs, top_w, top_i = self.real(params, cfg, xf)
            if self.replay is not None:
                import torch
                top_i = self.replay[len(self.calls)][0]
                top_w = torch.gather(probs, 1, top_i)
                top_w = (top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                                 1e-9)).to(xf.dtype)
            self.calls.append((top_i, moe.topk_margin(probs,
                                                      cfg.moe.top_k)))
            return probs, top_w, top_i
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def routing_diff(kern_calls, plain_calls) -> list:
    """Per MoE layer: the tokens whose expert set differs between the two
    runs, and the kernel run's top-k margins of those tokens."""
    out = []
    for layer, ((ki, km), (pi, _)) in enumerate(zip(kern_calls,
                                                    plain_calls)):
        differ = (ki.sort(-1).values != pi.sort(-1).values).any(-1)
        out.append(dict(layer=layer, tokens=int(ki.shape[0]),
                        differing=int(differ.sum()),
                        margins=[float(x) for x in km[differ][:16]],
                        max_flip_margin=(float(km[differ].max())
                                         if bool(differ.any()) else None),
                        min_margin=float(km.min())))
    return out


def family_prefills(api, cfg, model, req, max_len, log) -> dict:
    """The warm kernel-path prefill (the API's default on the card) and the
    plain-path prefill of the same prompt, each with its routing recorded
    (MoE), compared: logits and every cache tensor within SERVE_REL_BOUND
    of its largest magnitude.  Where a routing choice flipped between the
    two and they disagree, every flipped token's kernel-run top-k margin
    must lie below FLIP_MARGIN; then the plain path runs again with the
    kernel run's choices, and that run is held to the bound instead."""
    import torch

    with torch.no_grad():
        with log:
            torch.cuda.synchronize()
            t0 = time.time()
            logits_k, cache_k = api.prefill(cfg, model, req, max_len)
            torch.cuda.synchronize()
            warm_s = time.time() - t0
        kern_calls = log.calls
        with log:
            t0 = time.time()
            logits_p, cache_p = api.prefill(cfg, model, req, max_len,
                                            use_kernel=False)
            torch.cuda.synchronize()
            plain_s = time.time() - t0
        plain_calls = log.calls
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    flips = routing_diff(kern_calls, plain_calls)
    n_flips = sum(f["differing"] for f in flips)

    kern_leaves = dict(named_leaves(cache_k))

    def compare(logits_p, cache_p):
        logit = _rel_diff(logits_k, logits_p)
        caches = {name: _rel_diff(kern_leaves[name], t)
                  for name, t in named_leaves(cache_p)}
        worst = max(caches.items(), key=lambda kv: kv[1][1])
        return logit, worst

    logit, worst = compare(logits_p, cache_p)
    res = dict(warm_prefill_ms=warm_s * 1e3, plain_prefill_ms=plain_s * 1e3,
               logits_max_abs_diff=logit[0], logits_max_rel_diff=logit[1],
               cache_worst=dict(tensor=worst[0], max_abs_diff=worst[1][0],
                                max_rel_diff=worst[1][1]),
               rel_bound=SERVE_REL_BOUND, routing_flips=n_flips,
               routing=flips if kern_calls else None)
    held = logit[1] <= SERVE_REL_BOUND and worst[1][1] <= SERVE_REL_BOUND
    if not held and n_flips:
        wide = [f for f in flips if f["differing"]
                and f["max_flip_margin"] >= FLIP_MARGIN]
        if wide:
            raise AssertionError(
                f"{cfg.name}: kernel vs plain prefill: logits {logit}, "
                f"cache {worst} over {SERVE_REL_BOUND}, and routing choices "
                f"flipped at top-k margins of {FLIP_MARGIN} or more, which "
                f"rounding does not explain: {wide}")
        del logits_p, cache_p
        log.replay = kern_calls
        with torch.no_grad(), log:
            logits_p, cache_p = api.prefill(cfg, model, req, max_len,
                                            use_kernel=False)
        log.replay = None
        logit, worst = compare(logits_p, cache_p)
        res["replayed_routing"] = dict(
            logits_max_rel_diff=logit[1],
            cache_worst=dict(tensor=worst[0], max_rel_diff=worst[1][1]))
        held = logit[1] <= SERVE_REL_BOUND and worst[1][1] <= SERVE_REL_BOUND
    if not held:
        raise AssertionError(f"{cfg.name}: kernel vs plain prefill: logits "
                             f"{logit}, cache {worst} over {SERVE_REL_BOUND}"
                             f"; routing flips {flips}")
    del logits_p, cache_p, kern_leaves
    res["logits_k"], res["cache_k"] = logits_k, cache_k
    return res


def moe_layer_split(moe, cfg, model, batch: int, prompt: int) -> dict:
    """One MoE layer of the model on a [batch, prompt, d] input (the serve
    shape): moe_forward's time against its expert products and shared
    experts alone, the rest being the dispatch and combine (routing,
    positions, scatter, gather)."""
    import torch
    import torch.nn.functional as F

    blk = next(b for b in model.layers if b.ffn_kind == "moe")
    p = blk.moe
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(31)
    x = torch.randn((batch, prompt, cfg.d_model), generator=gen,
                    device=DEVICE)
    n = batch * prompt
    cap = moe.expert_capacity(n, cfg)
    eb = torch.randn((cfg.moe.n_experts, cap, cfg.d_model), generator=gen,
                     device=DEVICE)
    xf = x.reshape(n, cfg.d_model)

    def experts():
        h = F.silu(torch.bmm(eb, p.w_gate)) * torch.bmm(eb, p.w_up)
        return torch.bmm(h, p.w_down)
    with torch.no_grad():
        total = event_ms(lambda: moe.moe_forward(p, cfg, x), 5)
        expert = event_ms(experts, 5)
        shared = event_ms(lambda: moe.layers.mlp(p.shared, xf), 5)
    return dict(tokens=n, capacity=cap, moe_forward_ms=total,
                expert_bmm_ms=expert, shared_ms=shared,
                dispatch_and_combine_ms=total - expert - shared)


def xlstm_block_split(xlstm, cfg, model, batch: int, prompt: int) -> dict:
    """One mLSTM and one sLSTM block on a [batch, prompt, d] input (the
    serve shape; host clock around synchronized work: the sLSTM loop is
    host-bound)."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(32)
    x = torch.randn((batch, prompt, cfg.d_model), generator=gen,
                    device=DEVICE)
    out = {}
    for kind, fn in (("mlstm", xlstm.mlstm_forward),
                     ("slstm", xlstm.slstm_forward)):
        blk = next(b for b in model.layers if b.kind == kind)
        params = getattr(blk, kind)
        with torch.no_grad():
            fn(params, cfg, x)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.time()
                fn(params, cfg, x)
                torch.cuda.synchronize()
                times.append((time.time() - t0) * 1e3)
        out[f"{kind}_block_ms"] = min(times)
        out[f"{kind}_blocks"] = sum(b.kind == kind for b in model.layers)
    return out


def serve_family(arch, batch, prompt, new, want_flash, fa, rl, kern) -> dict:
    """One family's model served at full width through
    ``launch.serve.serve`` (its main path, counted), then its warm and
    plain prefills compared (`family_prefills`), a profiled prefill, warm
    decode turns, and the layer split of its own recurrence or dispatch."""
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.models import api, moe, xlstm
    from repro_torch.train import make_decode_step
    from repro_torch.train.serve_step import prompt_length

    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCH_COUNT = rl.LAUNCH_COUNT = ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    t0 = time.time()
    out = serve(arch, batch=batch, prompt_len=prompt, new_tokens=new,
                preset="full", seed=0)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(flash_attention=fa.LAUNCH_COUNT, rg_lru=rl.LAUNCH_COUNT,
                    mltcp_step=ms.LAUNCH_COUNT, netsim_chunk=nc.LAUNCH_COUNT,
                    fallbacks=ops.FALLBACK_COUNT + ops.CHUNK_FALLBACK_COUNT)
    want = dict(flash_attention=want_flash, rg_lru=0, mltcp_step=0,
                netsim_chunk=0, fallbacks=0)
    if launches != want:
        raise AssertionError(f"{arch} serve launches {launches}, expected "
                             f"{want}")
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, model, req = out["cfg"], out["model"], out["request"]
    gen_ids = out["generated"]
    if (tuple(gen_ids.shape) != (batch, new) or int(gen_ids.min()) < 0
            or int(gen_ids.max()) >= cfg.vocab_padded):
        raise AssertionError(f"{arch}: generated ids {tuple(gen_ids.shape)} "
                             f"out of range")
    n_params = sum(p.numel() for p in model.parameters())

    stamps = [time.time()]
    fa.LAUNCH_COUNT = 0
    res = family_prefills(api, cfg, model, req, out["max_len"],
                          RoutingLog(moe))
    stamps.append(time.time())
    if fa.LAUNCH_COUNT != want_flash:
        raise AssertionError(f"{arch}: the warm prefill launched "
                             f"{fa.LAUNCH_COUNT} flash kernels, expected "
                             f"{want_flash}")
    logits_k, cache_k = res.pop("logits_k"), res.pop("cache_k")
    if not torch.equal(gen_ids[:, 0].long(), torch.argmax(logits_k, -1)):
        raise AssertionError(f"{arch}: serve's first token is not the "
                             f"prefill argmax")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    def one_prefill():
        with torch.no_grad():
            api.prefill(cfg, model, req, out["max_len"])
    # where a kernel is on the path, a profiled prefill; xlstm's is ~3e5
    # launches of its host-bound sLSTM loop, a minute to trace (12.8% busy
    # in PERF.md's run), and its block split below times its blocks
    prof = None
    if want_flash:
        prof = profile_top(one_prefill, ("flash_kernel", "gemm"), n=8,
                           host=False)
        if prof["kernels"]["flash_kernel"]["count"] != want_flash:
            raise AssertionError(f"{arch}: the profiled prefill traced "
                                 f"{prof['kernels']['flash_kernel']} flash")
    stamps.append(time.time())

    decode = make_decode_step(cfg)
    pos0 = prompt_length(cfg, req)
    turn_s = []
    with torch.no_grad():
        # timing only: the turns decode the same positions again, from the
        # prefill's cache as the previous turn left it
        for _ in range(FAMILY_DECODE_TURNS):
            torch.cuda.synchronize()
            t1 = time.time()
            tok, cache = gen_ids[:, 0], cache_k
            for i in range(new - 1):
                tok, cache = decode(model, cache, tok, pos0 + i)
            torch.cuda.synchronize()
            turn_s.append(time.time() - t1)
    warm_rates = [batch * (new - 1) / t for t in turn_s]
    stamps.append(time.time())
    split = (moe_layer_split(moe, cfg, model, batch, prompt)
             if cfg.moe is not None
             else xlstm_block_split(xlstm, cfg, model, batch, prompt)
             if "slstm" in cfg.block_pattern else None)
    stamps.append(time.time())
    res.update(
        arch=arch, preset="full", batch=batch, prompt_len=prompt,
        new_tokens=new, seed=0, params=n_params,
        param_gb=n_params * 4 / 1e9, launches=launches,
        kernels_on_path=["flash_attention"] if want_flash else [],
        seconds_total=seconds, prefill_ms=out["prefill_s"] * 1e3,
        decode_tok_per_s=out["decode_tok_per_s"],
        warm_decode_tok_per_s=statistics.median(warm_rates),
        warm_decode_tok_per_s_turns=warm_rates,
        prefill_tok_per_s=batch * prompt / out["prefill_s"],
        serve_peak_memory_gb=serve_peak_gb, peak_memory_gb=peak_gb,
        prefill_profile=prof, layer_split=split,
        # host seconds of this function's steps after serve
        step_seconds=dict(zip(("prefills", "profile", "decode", "split"),
                              (b - a for a, b in zip(stamps, stamps[1:])))),
        generated_first_row=[int(x) for x in gen_ids[0]])
    if cfg.enc_layers:
        res["frames"] = int(req["frames"].shape[1])
    del out, model, cache_k, logits_k, req
    torch.cuda.empty_cache()
    return res


def phase_serve_families(fa, rl, kern) -> dict:
    """deepseek-moe-16b, xlstm-125m and seamless-m4t-medium served at full
    width, one after the other (deepseek's 65.5 GB of f32 weights first,
    on a card the training phase has left empty)."""
    res = {arch: serve_family(arch, b, t, n, f, fa, rl, kern)
           for arch, b, t, n, f in SERVE_FAMILIES}
    emit("serve_families", **res)
    return res


# ---------------------------------------------------------------------------
# the shared-cluster driver
# ---------------------------------------------------------------------------

CLUSTER_JOBS = ["qwen3-1.7b", "qwen3-1.7b", "olmo-1b"]   # the example's
# a mix with a MoE job: deepseek-moe-16b's dp+ep profile, two
# bursts an iteration (the expert all-to-all, the data-parallel all-reduce)
MOE_CLUSTER_JOBS = ["deepseek-moe-16b", "qwen3-1.7b", "qwen3-1.7b"]
CLUSTER_WORK_SCALE = 0.05
CLUSTER_SIM_TIME = 4.0


def cluster_run(kern, jobs) -> dict:
    """``cluster.simulate_shared_cluster(jobs)`` at the example's defaults
    (DCQCN, default against MLTCP-WI, 4 s, seed 0) through ``run_plan``
    and the chunk kernel, its launches counted alone; raises on a
    fallback, a per-tick launch or a non-finite value."""
    import torch

    from repro_torch import cluster
    from repro_torch.configs import get_config

    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    profiles = {a: cluster.profile_from_arch(get_config(a))
                for a in dict.fromkeys(jobs)}
    torch.cuda.synchronize()
    ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    t0 = time.time()
    rep = cluster.simulate_shared_cluster(jobs)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(netsim_chunk=nc.LAUNCH_COUNT, mltcp_step=ms.LAUNCH_COUNT,
                    fallbacks=ops.FALLBACK_COUNT + ops.CHUNK_FALLBACK_COUNT)
    values = (rep.baseline_avg + rep.mltcp_avg
              + [rep.avg_speedup, rep.p99_speedup, rep.interleave_before,
                 rep.interleave_after])
    if (launches["netsim_chunk"] == 0 or launches["fallbacks"]
            or launches["mltcp_step"] or not all(map(math.isfinite, values))):
        raise AssertionError(f"cluster run {jobs}: launches {launches}, "
                             f"values {values}")
    return dict(
        jobs=jobs, algo="dcqcn", sim_time=CLUSTER_SIM_TIME, seed=0,
        work_scale=CLUSTER_WORK_SCALE, hw="h100-sxm5-80gb (data sheet)",
        ticks_per_point=round(CLUSTER_SIM_TIME / DT),
        profiles={a: dict(parallelism=p.parallelism,
                          comm_bytes=p.comm_bytes, compute_s=p.compute_s,
                          scaled_comm_bytes=[b * CLUSTER_WORK_SCALE
                                             for b in p.comm_bytes],
                          scaled_compute_s=[c * CLUSTER_WORK_SCALE
                                            for c in p.compute_s])
                  for a, p in profiles.items()},
        baseline_avg_iter_s=rep.baseline_avg, mltcp_avg_iter_s=rep.mltcp_avg,
        avg_speedup=rep.avg_speedup, p99_speedup=rep.p99_speedup,
        interleave_before=rep.interleave_before,
        interleave_after=rep.interleave_after, launches=launches,
        seconds=seconds)


def phase_cluster(kern) -> dict:
    """The shared-cluster driver on the example's mix, then on the mix
    with a MoE job (its dp+ep profile), each counted alone."""
    res = cluster_run(kern, CLUSTER_JOBS)
    moe_mix = cluster_run(kern, MOE_CLUSTER_JOBS)
    if moe_mix["profiles"]["deepseek-moe-16b"]["parallelism"] != "dp+ep":
        raise AssertionError("the MoE job's profile is not dp+ep")
    res["moe_mix"] = moe_mix
    emit("cluster", **res)
    return res


def armed_attributes(nc, netsim, core, workload) -> dict:
    """Registers, spills and static shared memory of each armed
    specialization, and the dynamic shared memory of the armed plans'
    points (the fig 5 and churn widths)."""
    import dataclasses

    out = {}
    for armed in (nc.ARM_TEL, nc.ARM_FAULTS, nc.ARM_TEL | nc.ARM_FAULTS):
        for algo, variant, agg, fac in sorted(nc.ARMED_SPECIALIZATIONS):
            out[f"armed{armed}_algo{algo}_var{variant}"] = \
                nc.kernel_attributes(algo, variant, agg, fac, armed)
    fig5 = dataclasses.replace(
        fig7_cfg(core, netsim, workload, "reno", 1, FIG5_SIM_TIME),
        telemetry=fig5_spec(netsim))
    churn = churn_plan(core, netsim, workload).build(
        dict(algo="reno", variant="WI", schedule="gauntlet", seed=1))
    return dict(specializations=out,
                registers_range=[min(x["registers"] for x in out.values()),
                                 max(x["registers"] for x in out.values())],
                spilling={k: x["local_bytes"] for k, x in out.items()
                          if x["local_bytes"]},
                smem_bytes={"fig5": nc.smem_bytes(**nc.shape_of(fig5)),
                            "churn": nc.smem_bytes(**nc.shape_of(churn))})


def kernel_table(kern: dict, main: dict, states: dict, chunks: dict,
                 timing: dict, prof: dict, plans: dict, lm: dict,
                 served: dict, armed: dict, tel: dict, flt: dict,
                 trained: dict, families: dict, clustered: dict) -> list:
    main_row = next(r for r in kern["main_shape"] if r["algo"] == 0)
    serve_attrs = lm["flash"]["attributes"]["float32_d256"]
    rg_attrs = lm["rg_lru"]["attributes"][
        f"float32_{lm['rg_lru']['route']}"]
    errs = [kern["max_abs_err"]] + [r["max_abs_err"] for r in
                                    kern["main_shape"] + kern["large"]]
    errs += [s["max_abs_err"] for s in states.values()]
    chunk_prof = prof["chunk"]
    return [{
        "name": "mltcp_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mltcp_step.cu",
        "replaces": REPLACES,
        # none on the main path, which runs the chunk kernel; one per tick
        # on the per-tick path (the chunk kernel's plain version, and the
        # card's path for the configurations the chunk kernel does not
        # take), counted in its timed fig7-reno turn
        "launches": main["per_tick_cc_launches"],
        "per_tick_path_launches": main["per_tick_path_launches"],
        "path": "per-tick",
        "max_abs_err": max(errs),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "device_ms": main_row["device_ms"],
        "plain_device_ms": main_row["plain_device_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": [main_row["k"], main_row["n"]],
        "large": [{k: r[k] for k in ("algo", "k", "n", "ms", "plain_ms",
                                     "device_ms", "plain_device_ms",
                                     "bound_ms", "bound_by", "gbytes_per_s")}
                  for r in kern["large"]],
    }, {
        "name": "netsim_chunk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/netsim_chunk.cu",
        "replaces": REPLACES,
        "launches": main["launches"],
        "path": "main",
        # each plan's own run, counted on its own (one launch per chunk
        # per group)
        "plan_launches": {name: plans[name]["launches"]["netsim_chunk"]
                          for name in ("fig10-reno", "fig10-dcqcn",
                                       "fig12")},
        # the armed kernel (telemetry and faults): its plans' launches, its
        # specializations, and fig7-reno armed against unarmed
        "armed_plan_launches": {"fig5": tel["launches"]["netsim_chunk"],
                                "churn": flt["launches"]["netsim_chunk"]},
        # the shared-cluster driver's run (default and MLTCP, 4 s each)
        "cluster_launches": clustered["launches"]["netsim_chunk"],
        "moe_cluster_launches":
            clustered["moe_mix"]["launches"]["netsim_chunk"],
        "armed": armed,
        "armed_us_per_tick": tel["fig7_reno"]["armed_us_per_tick"],
        "unarmed_us_per_tick": tel["fig7_reno"]["unarmed_us_per_tick"],
        "max_abs_err": max([timing["max_abs_err"]]
                           + [c["max_abs_err"] for c in chunks.values()]),
        "armed_cases_bitwise": sorted(name for name, c in chunks.items()
                                      if c["armed"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "device_ms": chunk_prof["kernel_device_us_per_launch"] * 1e-3,
        "device_ms_per_tick": chunk_prof["kernel_device_us_per_tick"] * 1e-3,
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "bound_model": timing["bound_model"],
        "library_ms": None,
        "ticks_per_launch": timing["ticks"],
        "us_per_tick": main["chunk_us_per_tick"],
        "per_tick_path_us_per_tick": main["per_tick_us_per_tick"],
        "registers": timing["attributes"]["registers"],
        "spill_bytes": timing["attributes"]["local_bytes"],
        "spilling_specializations": timing["spilling"],
        "smem_bytes": timing["smem_bytes"],
        "static_smem_bytes": timing["attributes"]["static_smem_bytes"],
        "shape": timing["shape"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": FLASH_REPLACES,
        "launches": served["launches"]["flash_attention"],
        "max_abs_err": lm["flash_f32_max_abs_err"],
        "ms": lm["flash"]["ms"],
        "plain_ms": lm["flash"]["plain_ms"],
        "bound_ms": lm["flash"]["bound_ms"],
        "bound_by": lm["flash"]["bound_by"],
        "library_ms": lm["flash"]["library_ms"],
        "back_to_back_ms": lm["flash"]["back_to_back_ms"],
        "plain_back_to_back_ms": lm["flash"]["plain_back_to_back_ms"],
        "library_back_to_back_ms": lm["flash"]["library_back_to_back_ms"],
        "library": lm["flash"]["library"],
        "registers": serve_attrs["registers"],
        "smem_bytes": serve_attrs["smem_bytes"],
        "spill_bytes": serve_attrs["local_bytes"],
        "path_device_ms": served["path_device_ms_per_launch"]["flash_kernel"],
        "bf16_max_abs_err": lm["flash_bf16_max_abs_err"],
        # the training path: 8 steps of recurrentgemma-2b (forward and
        # remat recompute; the backward is the dense VJP, no launch)
        "train_launches": trained["launches"]["flash_attention"],
        "train_launches_per_step":
            trained["launches_per_step"]["flash_attention"],
        # the families' serve paths, a prefill each, counted alone
        "family_launches": {arch: r["launches"]["flash_attention"]
                            for arch, r in families.items()},
        "family_shapes": lm["flash"]["family_shapes"],
        "backward": trained["grad_checks"]["flash"],
        "shape": lm["flash"]["shape"],
    }, {
        "name": "rg_lru",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
        "replaces": RGLRU_REPLACES,
        "launches": served["launches"]["rg_lru"],
        "max_abs_err": lm["rg_lru"]["max_abs_err"],
        "ms": lm["rg_lru"]["ms"],
        "plain_ms": lm["rg_lru"]["plain_ms"],
        "bound_ms": lm["rg_lru"]["bound_ms"],
        "bound_by": lm["rg_lru"]["bound_by"],
        "library_ms": None,
        "back_to_back_ms": lm["rg_lru"]["back_to_back_ms"],
        "plain_back_to_back_ms": lm["rg_lru"]["plain_back_to_back_ms"],
        "copy_yardstick_ms": lm["rg_lru"]["copy_yardstick_ms"],
        "path_device_ms": served["path_device_ms_per_launch"]["rg_lru_kernel"],
        "specialization": lm["rg_lru"]["route"],
        # the training path: forward, remat recompute and the reverse scan
        "train_launches": trained["launches"]["rg_lru"],
        "train_launches_per_step": trained["launches_per_step"]["rg_lru"],
        "backward": trained["grad_checks"]["rg_lru"],
        "registers": rg_attrs["registers"],
        "static_smem_bytes": rg_attrs["static_smem_bytes"],
        "dynamic_smem_bytes": rg_attrs["dynamic_smem_bytes"],
        "spill_bytes": rg_attrs["local_bytes"],
        "shape": lm["rg_lru"]["shape"],
    }]


# every row of the kernels line has these keys; "route" says how the
# kernel was written
KERNEL_ROW_KEYS = ("name", "route", "source", "replaces", "launches",
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")
KERNEL_ROUTES = ("cuda", "triton")


def check_kernel_table(table: list) -> None:
    """Raises unless every row has every key of KERNEL_ROW_KEYS and a route
    of KERNEL_ROUTES."""
    for row in table:
        missing = [k for k in KERNEL_ROW_KEYS if k not in row]
        if missing or row["route"] not in KERNEL_ROUTES:
            raise AssertionError(f"kernels row {row.get('name')!r}: missing "
                                 f"{missing}, route {row.get('route')!r}")


PROBES = ("flash_attention", "rg_lru")


def write_results(path, t_start: float) -> None:
    RESULTS["seconds"] = time.time() - t_start
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(RESULTS, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's JSON here")
    ap.add_argument("--probe", nargs="+", metavar=("KERNEL", "SOURCE"),
                    help="only the short probe of one kernel (" +
                         ", ".join(PROBES) + "), timing the checkout's "
                         "kernel beside these other sources of it")
    ap.add_argument("--probe-flash", nargs="*", metavar="SOURCE",
                    help="the same as --probe flash_attention SOURCE ...")
    args = ap.parse_args(argv)
    probe = args.probe
    if args.probe_flash is not None:
        probe = ["flash_attention", *args.probe_flash]
    if probe and probe[0] not in PROBES:
        ap.error(f"--probe takes one of {', '.join(PROBES)}, not {probe[0]}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core, netsim, workload
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mltcp_step as ms
    from repro_torch.kernels import netsim_chunk as nc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rg_lru as rl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    sim_kernels = dict(ms=ms, nc=nc, ops=ops)
    if probe:
        if probe[0] == "flash_attention":
            probe_flash(fa, ref, probe[1:])
        else:
            probe_rg_lru(rl, ref, probe[1:])
        write_results(args.out, t_start)
        return 0
    dev = phase_device([ms.LIBRARY, nc.LIBRARY, fa.LIBRARY, rl.LIBRARY])
    kern = phase_kernel(ms, core)
    chunks = phase_chunk_vs_per_tick(sim_kernels, core, netsim, workload)
    main_path = phase_main_path(sim_kernels, core, netsim, workload)
    phase_small_agreement(core, netsim)
    states = phase_engine_states(sim_kernels, core, netsim, workload)
    timing = phase_chunk_timing(sim_kernels, core, netsim, workload)
    prof = phase_profile(sim_kernels, core, netsim, workload)
    plans = phase_plans(sim_kernels, core, netsim, workload)
    tel = phase_telemetry(sim_kernels, core, netsim, workload)
    flt = phase_faults(sim_kernels, core, netsim, workload)
    armed = armed_attributes(nc, netsim, core, workload)
    lm = phase_lm_kernels(fa, rl, ref)
    served = phase_serve(fa, rl, sim_kernels)
    trained = phase_train(fa, rl, ref, sim_kernels)
    families = phase_serve_families(fa, rl, sim_kernels)
    clustered = phase_cluster(sim_kernels)
    table = kernel_table(kern, main_path, states, chunks, timing, prof,
                         plans, lm, served, armed, tel, flt, trained,
                         families, clustered)
    check_kernel_table(table)
    RESULTS["kernels"] = table
    write_results(args.out, t_start)
    print(json.dumps({"kernels": table}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
