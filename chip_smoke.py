#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --only PHASE [PHASE ...] [--out results.json]
    python3 chip_smoke.py --probe KERNEL [OLD/KERNEL.cu ...]

It builds the port's four kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, all started together; sm_90a, into
``build/kernels/``) and drives these paths:

* the simulator: it holds the fused CC-tick kernel bit for bit against its
  plain PyTorch version for every specialization, holds the chunk kernel
  (a whole chunk of fabric ticks per launch) bit for bit against the
  per-tick path on every output leaf for each algorithm, variant and
  engine option at the paper's widths, and its armed kernel (one per
  algorithm and ARMED; every telemetry probe and detector, all four fault
  channels) on every leaf, the telemetry state's included, on each CC
  specialization (every algorithm under WI, MD and BOTH, per-flow
  statistics, Static factors), holds the per-tick path replayed as a CUDA
  graph of a chunk (``netsim.tick_graph``, the path those comparisons run)
  bit for bit against its eager loop on every leaf (each algorithm and
  variant, Static factors, F3, the fig 5 telemetry spec, the churn faults,
  a fallback favoritism; a registered probe keeps the eager loop, counted)
  and times both with the graph's capture and nodes, drives the
  simulator's main path
  through the chunk kernel at full width (the paper's Fig. 7-9 convergence
  setup: two GPT-2 jobs on a 50 Gbps dumbbell, Reno OFF and WI, a two-seed
  sweep each, the suite's 1.5 s of simulated time), checks the figure
  metrics, times both paths in turns, and feeds the CC kernel states taken
  from CUBIC and DCQCN runs of the engine;
* experiment plans: it runs the paper's fig 10 plans (Reno and DCQCN:
  OFF/WI x 2-6 jobs, two padded groups of K=5 each) and fig 12 plan
  (straggle probability x base/MLQCN/Cassini on DCQCN with ECN) through
  ``netsim.run_plan`` and the chunk kernel at the suites' 1.5 s and seeds
  1-32, counts each plan's launches on its own, reports every cell at
  seeds 1-3 beside the JAX reference's numbers for the same seeds
  (``results/reference_plans.json``, written by
  ``scripts/reference_plans.py``) and holds every cell at seeds 1-32 to
  the reference's distribution over the same seeds
  (``results/reference_seeds.json``, ``--seeds 32``: a Mann-Whitney U per
  metric, Fisher's exact test on the "never" counts, Holm at 0.01 over
  the phase), holds a padded-jobs point bit for bit against the same
  point run alone, serves the fig 12 plan a second time from the plan
  cache with no launch, and times one group as K grows from 2 to 512;
* the other figure plans (``figures``): figs 7-9 (every algorithm, OFF
  and WI), Table 2 (four snapshots on the two-tier fabric, each job
  alone), fig 13 (Static against MLQCN), fig 14 (the triangle, Cassini
  without a schedule), fig 15 (F1..F6 in the CC kernels), fig 16 (S x I,
  one WI group of K = 48), fig 17 (WI against MD) and kernel_sweep,
  the suites' own plans (``repro_torch.figures`` through
  ``analysis/plans.py``), through
  ``run_plan`` and the chunk kernel at 1.5 s and seeds 1-32, each
  counted: groups as the plan lint predicted and as the suites assert,
  at seeds 1-3 each cell beside the reference's and the paper's claims
  held wherever the reference holds them at the same seed, at seeds 1-32
  every cell and claim held to the reference's distribution as in the
  plans phase (claims by Fisher's exact test on the seeds where they
  hold), F1 bit for bit equal to linear(1.75, 0.25), and kernel_sweep's
  chunk and per-tick paths in turns; the CC
  tick's and the chunk kernel's parity cases include F1..F6, and the
  chunk kernel's the plans' own shapes (fig 14's triangle under its
  Cassini schedule, Table 2's one-hot job masks on its two-tier fabric,
  fig 13's Static factors at 3 jobs);
* the paper-figure harness (``suites``): every suite of
  ``repro_torch.figures`` (the port of ``benchmarks/``) run in-process as
  ``python -m repro_torch.figures`` runs it, at REPRO_SMOKE depth (1.5 s,
  seed 1; the churn gauntlet its own 4.5 s at seeds 1-3), each counted:
  every group on the chunk kernel (kernel_sweep's per-tick oracle, a CUDA
  graph of a chunk at the suite's own 1.5 s, counted apart and held bit
  for bit to the fused mode's points), its ``_health`` without fallback,
  mispredict, group error or budget mismatch, its derived keys those the
  reference recorded (``results/benchmarks.json``), its values at seed 1
  beside the reference's within the earlier phases' tolerances, its own
  assertions held, and ``churn.run()`` raising the Reno re-interleave
  assertion the reference raises at seeds 1-3 while
  ``churn.run(algos=("cubic", "dcqcn"))`` holds;
* telemetry and faults: the fig 5 timeline plan (benchmarks/timeline.py:
  Reno, CUBIC, DCQCN x OFF/WI x seeds 1-3 with the suite's probes and
  detectors) and the churn gauntlet (benchmarks/churn.py: three jobs on a
  100 Gbps dumbbell, churn, flaps and blackholes as a schedule axis)
  through ``run_plan`` and the armed chunk kernel, each counted, held to
  its suite's assertions and beside the reference's numbers; the
  sketch's ``logf`` against ``torch.log`` on every float32 in its range;
  fig7-reno armed and unarmed in turns; fig 17's plan (WI against MD) and
  fig 13's (Static factors) armed with the fig 5 spec, each bit for bit
  on every non-telemetry leaf against its unarmed run;
* the static verifier: ``repro_torch.analysis``'s gate over its five CI
  plans (fig 12, fig 13, fig 5 armed and unarmed, kernel_sweep, churn:
  ``analysis/plans.py``, whence the fig 12, fig 5 and churn phases take
  their plans too), each group run once for its first chunk through the
  chunk kernel, the launch contract read from the library, the envelopes
  against ``analysis/budgets.json``; every plan phase (and the cluster
  phase) holds the plan lint's predicted groups to the groups it ran;
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
* the examples (``repro_torch.examples``), each as ``python -m
  repro_torch.examples.<name>`` runs it at its defaults: interleave_demo
  (the armed chunk kernel), simulate_cluster, serve_lm on
  recurrentgemma-2b (flash and RG-LRU) and quickstart (xlstm-125m, no
  kernel; its loss assertion), each counted, its lines printed.

* the one-card dry run (``dryrun``): every (architecture x shape) cell of
  ``repro_torch.launch.dryrun`` counted on the meta device (32 counted, 8
  skipped as documented) with its H100 roofline terms; recurrentgemma-2b
  served in bf16 through ``launch.serve`` (1 x 4096) and its prefill held
  against the bf16 plain path; six cells run on the card at one row
  (full width and depth, weights from seed 0), each warm step's kernel
  launches equal to the planned ones, its arguments and its own bytes
  each between the count and the count plus the caching allocator's
  rounding, and its time at or above the roofline bound; and flash at
  qwen3-1.7b's prefill_32k shape in bf16, held row by row against SDPA's
  FLASH backend and the port's chunked plain route, beside its bound and
  SDPA's time;
* the device mesh (``mesh``): each device's share of three full-size
  cells (qwen3-1.7b train_4k, recurrentgemma-2b prefill_32k,
  llama4-maverick train_4k with FSDP) as rank 0 of a fake 16 x 16
  process group, its shards on the card: each counted first on meta
  shards, each warm step's launches equal to the planned ones and its
  time at or above the per-device bound, its peak beside the counted
  one, and each kernel held to its plain version at the local shapes the
  cell gave it; on a machine with four cards, a real NCCL (2, 2) train
  step against the one-card step of the same weights, and NCCL's
  collective bytes equal to the fake group's count;
* the hillclimb (``hillclimb``): the twelve experiments of
  ``repro_torch.roofline.hillclimb`` (the reference's rules and knobs),
  each counted on the kernel route on meta shards of 16 x 16, and each
  whose count fits the card and differs from every earlier one run as
  rank 0's share on the card, cold and then HILLCLIMB_WARM times, held as
  a ``mesh`` cell is held; one line an experiment sets its counted bound
  and its time on the card, each as a ratio to its baseline's.

``--only PHASE ...`` builds the kernels of the phases named and runs
those alone, in that order: ``dryrun``, ``mesh`` and ``hillclimb`` the
two LM kernels;
``suites``,
``per_tick_graph``, ``plans`` and ``figures`` the two simulator kernels.
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
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense
DT = 2e-5
RTT = 100e-6
WORK_SCALE = 0.25                  # benchmarks/common.py (not REPRO_FULL)
# Depth of the main path: the suite's REPRO_SMOKE depth, 1.5 s (75,000
# ticks), through the chunk kernel; widths, jobs and protocol settings are
# the suite's.  The per-tick path (a CUDA graph of a chunk, 5 ticks at
# this depth) is timed beside it at PER_TICK_SIM_TIME.
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
# side, a CUDA graph of a chunk, sets its cost)
CHUNK_CASE_SIM_TIME = 0.06
CHUNK_CASE_SCALE = 0.25
# depth of the armed kernel's cases (telemetry and faults armed), at the
# same workload scale
ARMED_CASE_SIM_TIME = 0.03
# the paper's F families (core/aggressiveness.py), which the CC kernels
# compute from the launch's F id, and the depth of their chunk cases
F_FAMILIES = ("F1", "F2", "F3", "F4", "F5", "F6")
F_CASE_SIM_TIME = 0.04
# depth and chunks of the graphed per-tick path's cases against its eager
# loop (the eager side, ~2-4 ms a tick on the card's host, sets their
# cost), and the chunks of the main path's size (187 ticks) its timing
# runs graphed and eager
GRAPH_CASE_SIM_TIME = 0.025
GRAPH_CASE_CHUNKS = 10
GRAPH_TIMING_CHUNKS = (20, 2)
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
UNARMED_FIG7_REGISTERS = 119

RESULTS: dict = {}
# the script's start, which each phase's ``at_s`` counts from
STARTED = time.time()


def emit(phase: str, **fields) -> None:
    """Record a phase's fields, with the seconds since the script started
    when it ended (``at_s``), and print them as one JSON line."""
    fields["at_s"] = time.time() - STARTED
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


@contextlib.contextmanager
def traced(activities):
    """A `torch.profiler.profile` session, the one way this script opens
    one, with the card idle at both of its edges.  `main` sets
    TEARDOWN_CUPTI=1 before torch loads, so that every session starts
    from a fresh CUPTI state: without it each session in a long process
    lost a few more device records than the last (4 more each cycle of
    three 303-kernel traces on an H100; a deepseek-moe-16b prefill lost 1
    of its 28 flash launches 10 minutes into this script); with it no
    session of the same 7-minute probe lost one (`scripts/cupti_probe.py`).
    The teardown completes in a later CUDA call: a process whose last
    CUDA work is a traced session does not exit, so the script's last
    session (`serve_families`) is followed by the cluster phase."""
    import torch
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


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
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with traced([ProfilerActivity.CUDA]) as prof:
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

def fuzz_operands(ms, core, algo, variant, aggregate, factors, k, n, gen,
                  f_spec="linear"):
    """Random mid-run operands on the card, in the ranges the CPU tests
    fuzz (tests/_torch_reference.py), under the F family ``f_spec``."""
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
    p = ms.static_params(core.CCParams(algo=algo, variant=variant), aggregate,
                         f_spec)
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


def hbm_bytes_per_s() -> float:
    """The H100's device-memory rate, from `repro_torch.roofline.hw` (the
    dry run's roofline reads the same)."""
    from repro_torch.roofline.hw import H100

    return H100.hbm_bw


def f32_ops_per_s() -> float:
    """The H100's float32 peak outside the tensor cores, from
    `repro_torch.roofline.hw`."""
    import torch

    from repro_torch.roofline.hw import H100

    return H100.peak_flops(torch.float32)


def bound_ms(ms, p, dyn, arrays, now, fac) -> tuple[float, str]:
    k, n = arrays["cwnd"].shape
    t_bytes = operand_bytes(ms, p, dyn, arrays, now, fac) / hbm_bytes_per_s()
    t_ops = OPS_PER_FLOW[p["algo"]] * k * n / f32_ops_per_s()
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
    # the paper's F1..F6 (the launch's F id) under every variant that
    # reads F, with and without factors
    n_f = 0
    for f_spec in F_FAMILIES:
        for algo in (0, 1, 2):
            for variant in (1, 2, 3):
                for factors in (False, True):
                    ops = fuzz_operands(ms, core, algo, variant, True,
                                        factors, 4, 1000, gen, f_spec)
                    worst = max(worst, compare_outputs(
                        ms, ms.mltcp_tick(*ops),
                        ms.mltcp_tick_reference(*ops)))
                    n_f += 1
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
    out = dict(specializations=n_specs, f_family_cases=n_f,
               f_families=list(F_FAMILIES), shape=[4, 1000], bitwise=True,
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


def read_counts(kern) -> dict:
    """Every launch, fallback and graph count, as they stand."""
    ms, nc, ops, tg = kern["ms"], kern["nc"], kern["ops"], kern["tg"]
    return dict(netsim_chunk=nc.LAUNCH_COUNT, mltcp_step=ms.LAUNCH_COUNT,
                fallbacks=ops.FALLBACK_COUNT,
                chunk_fallbacks=ops.CHUNK_FALLBACK_COUNT,
                graph_captures=tg.CAPTURE_COUNT,
                graph_replays=tg.REPLAY_COUNT, eager_runs=tg.EAGER_COUNT)


def counted(kern, fn):
    """``fn()`` with every launch, fallback and graph count set to 0 just
    before and read just after, timed on the host clock around a
    synchronized run; returns (fn's result, seconds, counts)."""
    import torch

    ms, nc, ops, tg = kern["ms"], kern["nc"], kern["ops"], kern["tg"]
    torch.cuda.synchronize()
    ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    tg.CAPTURE_COUNT = tg.REPLAY_COUNT = tg.EAGER_COUNT = 0
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    return out, seconds, read_counts(kern)


def run_counted(kern, cfg, sweep=None, per_tick=False, eager=False):
    """One sweep, `counted`; returns (raw, seconds, counts).
    ``per_tick`` runs the per-tick path (the chunk kernel's plain version,
    one CUDA graph replay a chunk) instead of the main path, ``eager`` its
    eager loop (the graph's plain version)."""
    from repro_torch import netsim
    from repro_torch.netsim import engine

    if sweep is None:
        sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
    if per_tick or eager:
        return counted(kern, lambda: engine.run_ticks(
            cfg, sweep, per_tick=per_tick, eager=eager))
    return counted(kern, lambda: netsim.simulate_sweep(cfg, sweep,
                                                       device=DEVICE))


# the graph counts of a run that takes no per-tick path
NO_GRAPH = dict(graph_captures=0, graph_replays=0, eager_runs=0)


def expected_counts(cfg, path="chunk", cc="mltcp_step") -> dict:
    """The counts of one run of ``cfg``: on the main path ("chunk") one
    chunk launch per chunk and nothing else; on the per-tick path
    ("graph") one capture, one replay per chunk and one CC launch (or
    ``cc="fallbacks"``: one call of `core.cc_tick`) per tick and per
    warm-up tick; on its eager loop ("eager") one CC launch per tick."""
    from repro_torch.netsim import tick_graph

    want = dict(netsim_chunk=0, mltcp_step=0, fallbacks=0,
                chunk_fallbacks=0, **NO_GRAPH)
    if path == "chunk":
        want["netsim_chunk"] = n_chunks_run(cfg)
    elif path == "graph":
        want.update(graph_captures=1, graph_replays=n_chunks_run(cfg))
        want[cc] = ticks_run(cfg) + tick_graph.WARM_UP_TICKS
    else:
        want[cc] = ticks_run(cfg)
    return want


def check_counts(what: str, cfg, counts: dict, per_tick=False) -> None:
    """The main path: one chunk launch per chunk, no per-tick CC launch,
    no fallback; the per-tick path: one graph captured and replayed once
    a chunk, one CC launch per tick (and per warm-up tick), no chunk."""
    want = expected_counts(cfg, "graph" if per_tick else "chunk")
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
    leaf/spine (M=9) with a 4-phase GPT-3 hybrid job; and the shapes only
    the figure plans drive: fig 14's triangle (three GPT-2 jobs, DCQCN OFF
    under the infeasible Cassini schedule, as its Cassini points ride the
    OFF group), Table 2's two-tier fabric (GPT-2 beside the GPT-3 hybrid)
    under its one-hot `solo` masks, OFF and WI, and fig 13's DCQCN WI at 3
    jobs with Static factors beside the adaptive sentinel.  The workload
    is scaled to a quarter of the suite's (iterations of ~12 ms, not
    ~45 ms) so that a short case completes iterations, and the Cassini
    schedule is `fig14_schedule`'s for that workload; the widths are the
    suite's."""
    import numpy as np

    from repro_torch.figures import partial_compat

    def cfg(algo, variant, **kw):
        return fig7_cfg(core, netsim, workload, algo, variant, sim_time,
                        scale=CHUNK_CASE_SCALE, **kw)
    seeds = dict(seed=list(SEEDS))
    triangle = netsim.triangle(sockets_per_job=2)
    sched, feasible = workload.cassini_schedule(triangle, [
        workload.profile_for("gpt2").scaled(WORK_SCALE * CHUNK_CASE_SCALE)
        for _ in range(3)])
    if feasible:
        raise AssertionError("Cassini found a schedule on fig 14's triangle")
    table2 = dict(topo=workload.table2_snapshots(sockets_per_job=2)[-1].topo,
                  models=("gpt2", "gpt3_hybrid"))
    solo = dict(seed=[SEEDS[0], SEEDS[1], SEEDS[0]],
                job_active=[[True, True], [True, False], [False, True]])
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
        ("fig14_triangle_dcqcn_off_cassini",
         cfg("dcqcn", 0, topo=triangle, models=("gpt2",) * 3,
             cassini=sched), seeds),
        ("table2_two_tier_dcqcn_off_solo", cfg("dcqcn", 0, **table2), solo),
        ("table2_two_tier_dcqcn_wi_solo", cfg("dcqcn", 1, **table2), solo),
        ("fig13_dcqcn_wi_static_3jobs",
         cfg("dcqcn", 1, topo=netsim.dumbbell(3, sockets_per_job=2),
             models=("gpt2",) * 3),
         dict(seed=list(SEEDS), static_job_factors=np.stack(
             [partial_compat.STATIC_FACTORS, np.full(3, -1.0)]))),
    ]


def f_cases(core, netsim, workload, sim_time: float) -> list:
    """(name, config, sweep overrides) of the F families in the chunk
    kernel: F1..F6 on Reno WI at fig 15's width (three GPT-2 jobs on
    dumbbell(3, 2)), and F3 (the one with a division) on CUBIC MD and on
    DCQCN WI at the fig 7 width; the workload as `chunk_cases` cuts it."""
    def cfg(algo, variant, f_spec, **kw):
        return fig7_cfg(core, netsim, workload, algo, variant, sim_time,
                        scale=CHUNK_CASE_SCALE,
                        proto_kw=dict(f_spec=f_spec), **kw)
    seeds = dict(seed=list(SEEDS))
    fig15 = dict(topo=netsim.dumbbell(3, sockets_per_job=2),
                 models=("gpt2",) * 3)
    return ([(f"reno_wi_{f}", cfg("reno", 1, f, **fig15), seeds)
             for f in F_FAMILIES]
            + [("cubic_md_F3", cfg("cubic", 2, "F3"), seeds),
               ("dcqcn_wi_F3", cfg("dcqcn", 1, "F3"), seeds)])


def armed_cases(core, netsim, workload, sim_time: float) -> list:
    """(name, config, sweep overrides) of the armed kernel's check.  Every
    algorithm (WI) at the fig 7 width (2 jobs) and at 3 jobs, with every
    built-in probe, the three detectors and all four fault channels; point
    0 under a schedule that departs and re-admits the last job, flaps the
    bottleneck, blackholes flow 0 and bursts the straggle probability,
    point 1 under the identity schedule.  The same at the fig 7 width on
    the CC selections the armed kernel takes as launch dims: each
    algorithm under MD and under BOTH, Reno and DCQCN with per-flow
    statistics, each algorithm with Static factors beside the adaptive
    sentinel (-1).  Then the specializations the two plan phases run, at
    their widths (`timeline.SOCKETS`: DCQCN one socket a job), OFF and
    WI: the fig 5 plan's (telemetry alone, `fig5_spec`) and the churn
    gauntlet's (`churn.telemetry_spec`, `churn.SPEC`, the 100 Gbps 3-job
    dumbbell, point 0 under the gauntlet schedule, point 1 under the
    staggered one)."""
    import numpy as np

    from repro_torch.analysis import plans as suites
    from repro_torch.figures import churn, timeline
    from repro_torch.netsim import telemetry

    spec = netsim.TelemetrySpec(probes=telemetry.BUILTIN_PROBES, stride=7,
                                detectors=telemetry.DETECTORS)
    faults = netsim.FaultSpec(n_events=10, churn=True, link_flaps=True,
                              blackholes=True, straggle_bursts=True)

    def fully_armed(name, algo, variant, n_jobs, proto_kw=None, **kw):
        cfg = fig7_cfg(core, netsim, workload, algo, variant, sim_time,
                       topo=netsim.dumbbell(n_jobs, sockets_per_job=2),
                       models=("gpt2",) * n_jobs, scale=CHUNK_CASE_SCALE,
                       proto_kw=proto_kw, telemetry=spec, faults=faults,
                       **kw)
        t = sim_time
        sched = netsim.fault_schedule(cfg, [
            netsim.job_departs(0.2 * t, n_jobs - 1),
            netsim.job_arrives(0.45 * t, n_jobs - 1),
            netsim.link_flap(0.3 * t, 0.6 * t, 0, 0.5),
            netsim.blackhole(0.1 * t, 0.35 * t, [0]),
            netsim.straggle_burst(0.05 * t, 0.7 * t, 0.5)], spec=faults)
        ident = netsim.identity_schedule(cfg, faults)
        return (name, cfg, dict(
            seed=list(SEEDS),
            **{f: np.stack([sched.values[f], ident.values[f]])
               for f in sched.values}))

    out = [fully_armed(f"{algo}_wi_armed_{n_jobs}jobs", algo, 1, n_jobs)
           for algo in ("reno", "cubic", "dcqcn") for n_jobs in (2, 3)]
    out += [fully_armed(f"{algo}_{name}_armed", algo, variant, 2)
            for algo in ("reno", "cubic", "dcqcn")
            for name, variant in (("md", 2), ("both", 3))]
    out += [fully_armed(f"{algo}_wi_per_flow_armed", algo, 1, 2,
                        proto_kw=dict(aggregate_by_job=False))
            for algo in ("reno", "dcqcn")]
    out += [fully_armed(f"{algo}_wi_static_armed", algo, 1, 2,
                        static_job_factors=np.asarray([1.3, -1.0]))
            for algo in ("reno", "cubic", "dcqcn")]
    churn_faults = churn.SPEC
    for algo, sockets in timeline.SOCKETS.items():
        for variant in VARIANT:
            cfg = fig7_cfg(core, netsim, workload, algo, VARIANT[variant],
                           sim_time, topo=netsim.dumbbell(
                               2, sockets_per_job=sockets),
                           scale=CHUNK_CASE_SCALE,
                           telemetry=suites.fig5_spec(FIG5_SIM_TIME))
            out.append((f"{algo}_{variant.lower()}_fig5", cfg,
                        dict(seed=list(SEEDS))))
            cfg = fig7_cfg(core, netsim, workload, algo, VARIANT[variant],
                           sim_time, topo=netsim.dumbbell(
                               churn.N_JOBS, sockets_per_job=sockets,
                               cap_gbps=churn.CAP_GBPS),
                           models=("gpt2",) * churn.N_JOBS,
                           scale=CHUNK_CASE_SCALE,
                           telemetry=churn.telemetry_spec(),
                           faults=churn_faults)
            scheds = [netsim.fault_schedule(
                cfg, churn._events(cfg, label), spec=churn_faults)
                for label in churn.SCHEDULES]
            out.append((f"{algo}_{variant.lower()}_churn", cfg, dict(
                seed=list(SEEDS),
                **{f: np.stack([sc.values[f] for sc in scheds])
                   for f in scheds[0].values})))
    return out


def phase_chunk_vs_per_tick(kern, core, netsim, workload) -> dict:
    """The chunk kernel against the per-tick path (its plain version, with
    the per-tick CC kernel, replayed as a CUDA graph a chunk) on the card:
    every leaf of RawSimOutput, final_state and telemetry included, bit for
    bit; the unarmed kernel on the engine options, the armed one on
    `armed_cases`."""
    out = {}
    sim_time = CHUNK_CASE_SIM_TIME
    cases = (chunk_cases(core, netsim, workload, sim_time)
             + f_cases(core, netsim, workload, F_CASE_SIM_TIME)
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
         f_sim_time=F_CASE_SIM_TIME, armed_sim_time=ARMED_CASE_SIM_TIME,
         cases=out)
    return out


def graph_cases(core, netsim, workload, sim_time: float) -> list:
    """(name, config, sweep overrides, route) of the graphed per-tick path
    against its eager loop, at the fig 7 width and a quarter of the
    suite's work an iteration: Reno OFF, WI and MD, CUBIC WI, DCQCN WI with
    ECN, Static factors, F3 (on CUBIC MD, where it completes iterations
    this early), the fig 5 plan's telemetry spec (the overlap
    detector included), the churn gauntlet's faults and detectors, and a
    favoritism the CC kernel does not take (``core.cc_tick`` each tick,
    graphed: route "graph-fallback"); and a registered probe, which keeps
    the eager loop (route "eager"), run through the main path's entry."""
    import numpy as np

    from repro_torch.analysis import plans as suites
    from repro_torch.figures import churn

    def cfg(algo, variant, **kw):
        return fig7_cfg(core, netsim, workload, algo, variant, sim_time,
                        scale=CHUNK_CASE_SCALE, n_chunks=GRAPH_CASE_CHUNKS,
                        **kw)
    seeds = dict(seed=list(SEEDS))
    churn_cfg = cfg("reno", 1, topo=netsim.dumbbell(
        churn.N_JOBS, sockets_per_job=2, cap_gbps=churn.CAP_GBPS),
        models=("gpt2",) * churn.N_JOBS, telemetry=churn.telemetry_spec(),
        faults=churn.SPEC)
    scheds = [netsim.fault_schedule(churn_cfg, churn._events(churn_cfg, lb),
                                    spec=churn.SPEC)
              for lb in churn.SCHEDULES]
    return [
        ("reno_off", cfg("reno", 0), seeds, "graph"),
        ("reno_wi", cfg("reno", 1), seeds, "graph"),
        ("reno_md", cfg("reno", 2), seeds, "graph"),
        ("cubic_wi", cfg("cubic", 1), seeds, "graph"),
        ("dcqcn_wi_ecn", cfg("dcqcn", 1), seeds, "graph"),
        ("reno_wi_static_factors",
         cfg("reno", 1, static_job_factors=np.asarray([0.6, -1.0])), seeds,
         "graph"),
        ("cubic_md_F3", cfg("cubic", 2, proto_kw=dict(f_spec="F3")), seeds,
         "graph"),
        ("cubic_wi_fig5_telemetry",
         cfg("cubic", 1, telemetry=suites.fig5_spec(FIG5_SIM_TIME)), seeds,
         "graph"),
        ("reno_wi_churn_faults", churn_cfg, dict(
            seed=list(SEEDS), **{f: np.stack([sc.values[f] for sc in scheds])
                                 for f in scheds[0].values}), "graph"),
        ("reno_wi_earliest_iter_start",
         cfg("reno", 1, proto_kw=dict(favoritism="earliest_iter_start")),
         seeds, "graph-fallback"),
        ("reno_wi_registered_probe",
         cfg("reno", 1, telemetry=netsim.TelemetrySpec(
             probes=("flow_cwnd", GRAPH_PROBE), stride=7)), seeds, "eager"),
    ]


# a probe added with `telemetry.register_probe` for the eager case: a
# Python callable, so the configuration keeps the eager loop
GRAPH_PROBE = "chip_smoke_cwnd_over_rate"


def graph_timing(kern, netsim, cfg, sweep) -> dict:
    """One config at the main path's chunk size on the per-tick path: its
    graph built by hand (`tick_graph.TickGraph`, as `run_ticks` builds it)
    for the capture's seconds, its nodes and the µs of one replay (CUDA
    events); then the graphed and eager runs in turns (eager, graphed,
    graphed, eager) over ``GRAPH_TIMING_CHUNKS`` chunks, each counted."""
    import dataclasses

    from repro_torch.netsim import engine, tick_graph

    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    statics = engine._build_statics(cfg, sweep.slope.device)
    st = engine._init_state(cfg, statics, sweep)
    wl = engine._workload_view(cfg, statics, sweep)
    graph = tick_graph.TickGraph(cfg, statics, sweep, wl, st)
    graph.step(engine.chunk_inputs(cfg, statics, sweep, graph, tpc))
    replay_ms = event_ms(graph._graph.replay, 20)
    runs = {}
    for path, chunks in zip(("graph", "eager"), GRAPH_TIMING_CHUNKS):
        runs[path] = dataclasses.replace(cfg, sim_time=chunks * tpc * cfg.dt,
                                         n_chunks=chunks)
    turns = []
    for path in ("eager", "graph", "graph", "eager"):
        c = runs[path]
        _, seconds, counts = run_counted(kern, c, sweep,
                                         per_tick=path == "graph",
                                         eager=path == "eager")
        want = expected_counts(c, path)
        if counts != want:
            raise AssertionError(f"graph timing {path}: {counts}, expected "
                                 f"{want}")
        turns.append(dict(path=path, ticks=ticks_run(c), seconds=seconds,
                          us_per_tick=1e6 * seconds / ticks_run(c)))
    med = {path: statistics.median(t["us_per_tick"] for t in turns
                                   if t["path"] == path)
           for path in ("graph", "eager")}
    return dict(k=int(sweep.slope.shape[0]), n=cfg.topo.n_flows,
                j=cfg.jobs.n_jobs, ticks_per_chunk=tpc,
                capture_s=graph.capture_s, instantiate_s=graph.instantiate_s,
                graph_nodes=graph.nodes, recorded=graph.recorded,
                nodes_per_tick=(None if graph.nodes is None
                                else graph.nodes / tpc),
                replay_ms=replay_ms, replay_us_per_tick=1e3 * replay_ms / tpc,
                turns=turns, graphed_us_per_tick=med["graph"],
                eager_us_per_tick=med["eager"],
                eager_over_graphed=med["eager"] / med["graph"])


def phase_per_tick_graph(kern, core, netsim, workload) -> dict:
    """The per-tick path replayed as a CUDA graph of a chunk against its
    eager loop on the card, on every leaf of RawSimOutput bit for bit
    (`graph_cases`), each run counted: the graphed one captures once,
    replays once a chunk and launches the CC kernel once a tick (and once
    a warm-up tick; the fallback case calls `core.cc_tick` instead), no
    chunk kernel; the registered probe's configuration takes the eager loop
    from the main path's entry with both reasons counted.  Then capture
    seconds, graph nodes, µs per replay and µs per tick graphed and eager
    (`graph_timing`) at fig7-reno (K = 2) and at kernel_sweep's group (its
    suite's REPRO_SMOKE seeds, 2 and 3 jobs padded: K = 2)."""
    from repro_torch.analysis import plans as suites
    from repro_torch.netsim import experiment, telemetry

    telemetry.register_probe(GRAPH_PROBE, "flow",
                             lambda s: s.cwnd / (1.0 + s.rate),
                             overwrite=True)
    cases = {}
    try:
        for name, cfg, overrides, route in graph_cases(
                core, netsim, workload, GRAPH_CASE_SIM_TIME):
            sweep = netsim.make_sweep(cfg, device=DEVICE, **overrides)
            want, eager_s, ecounts = run_counted(kern, cfg, sweep, eager=True)
            cc = "fallbacks" if route == "graph-fallback" else "mltcp_step"
            if ecounts != expected_counts(cfg, "eager", cc):
                raise AssertionError(f"{name} eager: {ecounts}")
            if route == "eager":
                got, seconds, counts = run_counted(kern, cfg, sweep)
                expect = dict(expected_counts(cfg, "eager"),
                              chunk_fallbacks=1, eager_runs=1)
            else:
                got, seconds, counts = run_counted(kern, cfg, sweep,
                                                   per_tick=True)
                expect = expected_counts(cfg, "graph", cc)
            if counts != expect:
                raise AssertionError(f"{name}: {counts}, expected {expect}")
            err, n_leaves = compare_trees(
                got, want, "graphed per-tick path != eager loop")
            if int(want.iter_counts.sum()) == 0:
                raise AssertionError(f"{name}: no iteration completed")
            cases[name] = dict(
                route=route, k=int(sweep.slope.shape[0]),
                ticks=ticks_run(cfg), chunks=n_chunks_run(cfg),
                leaves=n_leaves, bitwise=True, max_abs_err=err,
                iterations=int(want.iter_counts.sum()), launches=counts,
                us_per_tick=1e6 * seconds / ticks_run(cfg),
                eager_us_per_tick=1e6 * eager_s / ticks_run(cfg))
    finally:
        del telemetry.PROBES[GRAPH_PROBE]
    fig7 = fig7_cfg(core, netsim, workload, "reno", 1, MAIN_SIM_TIME)
    timing = {"fig7_reno": graph_timing(
        kern, netsim, fig7, netsim.make_sweep(fig7, device=DEVICE,
                                              seed=list(SEEDS)))}
    _, cfgs, overrides, groups = experiment.resolve_plan(
        suites.kernel_sweep_plan(FIGURE_SIM_TIME, (1,)))
    (group,) = groups
    timing["kernel_sweep"] = graph_timing(
        kern, netsim, group.cfg,
        experiment.group_sweep(cfgs, overrides, group, device=DEVICE))
    out = dict(sim_time=GRAPH_CASE_SIM_TIME, cases=cases, timing=timing)
    emit("per_tick_graph", **out)
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
    times = {"bytes": nbytes / hbm_bytes_per_s(),
             "operations": k * ticks * ops / f32_ops_per_s(),
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
    the per-tick path (two chunks of 150), graphed and eager.  Each: the
    card's busy time per tick, its share of the (profiled) wall time, the
    device-side launches per tick and the kernel's own device time per
    launch.  The profiler adds host cost, so the busy share is a lower
    bound."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.netsim import engine

    def window(cfg, per_tick, key, eager=False):
        sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
        engine.run_ticks(cfg, sweep, per_tick=per_tick, eager=eager)
        torch.cuda.synchronize()
        with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            engine.run_ticks(cfg, sweep, per_tick=per_tick, eager=eager)
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
    tick_cfg = fig7_cfg(core, netsim, workload, "reno", 1, 300 * DT,
                        n_chunks=2)
    out = dict(chunk=window(chunk_cfg, False, "netsim_chunk_kernel"),
               per_tick=window(tick_cfg, True, "mltcp_step_kernel"),
               per_tick_eager=window(tick_cfg, False, "mltcp_step_kernel",
                                     eager=True))
    emit("profile", **out)
    return out


# ---------------------------------------------------------------------------
# experiment plans: the paper's fig 10 and fig 12 through run_plan
# ---------------------------------------------------------------------------

# The suites' plans (repro_torch/figures/speedup_vs_jobs.py, stragglers.py)
# at their REPRO_SMOKE depth, at seeds 1-32: the reference's distribution
# over the same seeds (results/reference_seeds.json) is what settles
# whether the port's cells differ from the reference's by chaos
# (`distribution_check`).  The paired checks (`tier_b`, the claims,
# `seed_spread`) read the columns of seeds 1-3, the reference's seeds in
# results/reference_plans.json; the chunk kernel runs each point alone, so
# those columns are what a run at seeds 1-3 gives.
PLAN_SIM_TIME = 1.5
PLAN_SEEDS = tuple(range(1, 33))
PAIRED_SEEDS = (1, 2, 3)
VARIANT = {"OFF": 0, "WI": 1}
# the JAX reference's numbers for the same plans, seeds 1-3 and 1-32
# (scripts/reference_plans.py, and with --seeds 32); the cache the second
# fig 12 run reads
REFERENCE_PLANS = os.path.join(ROOT, "results", "reference_plans.json")
REFERENCE_SEEDS = os.path.join(ROOT, "results", "reference_seeds.json")
PLAN_CACHE = os.path.join(ROOT, "build", "plan_cache")
# One group at growing K: fig7-reno WI (N = 4) at 0.3 s, the point
# repeated across seeds 1..K, in the config's 400 chunks (37 ticks each)
# and in 80 (187 ticks, the main path's chunk size); 512 is fig 16's WI
# group at 32 seeds.
K_SCALING = (2, 21, 132, 264, 512)
K_SIM_TIME = 0.3
K_CHUNKS = (400, 80)


def predicted_groups(plan, telemetry=None) -> int:
    """The plan lint's prediction of a plan's groups
    (`analysis.plan_lint.lint_plan`), taken before its run as
    benchmarks/common.py's ``run_plan`` takes it; raises on a finding above
    info (an avoidable split)."""
    from repro_torch.analysis import plan_lint

    findings, facts = plan_lint.lint_plan(plan, label=plan.name,
                                          telemetry=telemetry)
    bad = [f for f in findings if f.effective_severity != "info"]
    if bad:
        raise AssertionError(f"plan {plan.name}: the plan lint finds {bad}")
    return facts["groups"]


def check_prediction(name: str, predicted: int, ran: int) -> None:
    """The run made as many groups as the plan lint predicted."""
    if predicted != ran:
        raise AssertionError(f"plan {name}: the plan lint predicted "
                             f"{predicted} groups, the run made {ran}")


def check_plan(pr, counts: dict, max_groups: int, idle=()) -> dict:
    """At most ``max_groups`` groups, one chunk launch per chunk per group,
    no per-tick CC launch, no fallback, and a finite iteration on every
    active job of every point but the [point label, job] pairs of
    ``idle`` (those the reference's run of the plan also leaves without
    one)."""
    import numpy as np

    cfg = pr.results[0].cfg
    active = reference_plan_script().active_jobs
    want = dict(netsim_chunk=pr.n_compile_groups * n_chunks_run(cfg),
                mltcp_step=0, fallbacks=0, chunk_fallbacks=0, **NO_GRAPH)
    if not 1 <= pr.n_compile_groups <= max_groups or counts != want:
        raise AssertionError(f"plan {pr.plan.name}: {pr.n_compile_groups} "
                             f"groups, counts {counts}, expected {want}")
    idle = {(label, j) for label, j in idle}
    for r in pr:
        if any(r.iter_times[j].size == 0
               or not np.all(np.isfinite(r.iter_times[j]))
               for j in active(r.point, len(r.iter_times))
               if (r.point.label(), j) not in idle):
            raise AssertionError(f"{pr.plan.name} {r.point.label()}: a job "
                                 f"recorded no finite iteration")
    return dict(n_compile_groups=pr.n_compile_groups,
                groups=[dict(k=g.n_points, n_jobs=g.n_jobs,
                             n_flows=g.n_flows, execute_s=g.execute_s,
                             us_per_point_tick=1e6 * g.execute_s
                             / g.n_ticks / g.n_points)
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
    axes = {a.name: a.values for a in pr.plan.axes}
    if pr.plan.name == "fig12":
        return {f"{scheme}@{p}": stats(pr.select(p=p, scheme="base"),
                                       pr.select(p=p, scheme=scheme))
                for p in axes["p"] for scheme in ("mlqcn", "cassini")}
    return {str(n): stats(pr.select(variant="OFF", n_jobs=n),
                          pr.select(variant="WI", n_jobs=n))
            for n in axes["n_jobs"]}


def plan_tolerance(plan: dict, metric: str) -> float:
    """`tier_b`'s tolerance of one metric of a reference plan entry: the
    widest spread the reference shows across its seeds in any cell."""
    spreads = [max(v) - min(v) for v in (
        [x for x in c[metric] if x is not None]
        for c in plan["cells"].values() if metric in c) if v]
    return max(spreads) if spreads else 0.0


def tier_b(name: str, cells: dict, ref: dict, seeds,
           metrics=("avg_speedup", "p99_speedup")) -> dict:
    """The port's cells against the reference's at the same seeds (each
    cell a {metric: [value per seed]}; None for "never", an infinite
    time; a cell without the metric is skipped).  The runs diverge
    chaotically (loss and CNP draws threshold on
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
        tol = plan_tolerance(plan, metric)
        out["tolerance"][metric] = tol
        n_out = n = 0
        for cell, got in cells.items():
            if metric not in got:
                continue
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


def reference_seeds(seeds) -> dict:
    """results/reference_seeds.json, which must hold ``seeds``."""
    with open(REFERENCE_SEEDS) as f:
        dist = json.load(f)
    if dist["seeds"] != list(seeds):
        raise AssertionError(f"{REFERENCE_SEEDS} holds seeds {dist['seeds']}"
                             f", not {list(seeds)}")
    return dist


def distribution(rows: list, seeds, named=(), outside=()) -> dict:
    """A phase's `distribution_check` rows (Holm over all of them) as its
    line reports them: the rows ``named`` by (plan, cell, metric), the
    rejected ones, and each of `tier_b`'s ``outside`` values (with its
    ``plan``) beside its metric's p and verdict."""
    by = {(r["plan"], r["cell"], r["metric"]): r for r in rows}
    return dict(seeds=[seeds[0], seeds[-1]],
                alpha=reference_plan_script().ALPHA, n_rows=len(rows),
                rejected=[r for r in rows if r["verdict"] == "reject"],
                named=[by[key] for key in named],
                outside=[dict(o, p=by[o["plan"], o["cell"], o["metric"]]["p"],
                              verdict=by[o["plan"], o["cell"],
                                         o["metric"]]["verdict"])
                         for o in outside],
                rows=rows)


def check_distribution(phase: str, dist: dict) -> None:
    """Fail the phase (after its line) on a rejected row."""
    if dist["rejected"]:
        raise AssertionError(
            f"{phase}: the port's distribution over seeds "
            f"{dist['seeds'][0]}-{dist['seeds'][1]} differs from the "
            f"reference's (Holm at {dist['alpha']}): "
            f"{[(r['plan'], r['cell'], r['metric'], r['p']) for r in dist['rejected']]}")


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
    """Every point of two plan results has the same axes and, bit for bit,
    the same value of every leaf but the telemetry: the iteration times,
    the drop and mark rates and the chunk traces."""
    import numpy as np

    def same(p, q):
        p, q = np.asarray(p), np.asarray(q)
        return p.dtype == q.dtype and p.shape == q.shape and \
            p.tobytes() == q.tobytes()
    return len(a) == len(b) and all(
        x.point.axes == y.point.axes
        and len(x.iter_times) == len(y.iter_times)
        and all(same(p, q) for p, q in zip(x.iter_times, y.iter_times))
        and all(same(getattr(x, f), getattr(y, f))
                for f in ("drops_per_s", "marks_per_s", "trace_t",
                          "trace_util", "trace_incomm", "trace_drops",
                          "trace_jobtput"))
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
    from torch.profiler import ProfilerActivity

    ticks = ticks_run(cfg)
    seeds = list(range(1, k + 1))
    sweep = netsim.make_sweep(cfg, device=DEVICE, seed=seeds)
    walls = []
    for _ in range(4):
        _, seconds, counts = run_counted(kern, cfg, sweep)
        check_counts(f"K={k}", cfg, counts)
        walls.append(seconds)
    wall_s = statistics.median(walls[1:])
    with traced([ProfilerActivity.CUDA]) as prof:
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
    `netsim.run_plan` on the card at seeds 1-32, each counted on its own;
    their cells at seeds 1-3 against the reference's numbers at the same
    seeds (Tier B), and at seeds 1-32 against the reference's distribution
    (`distribution_check`, which fails the phase after its line on a
    rejected row); a padded point against its unpadded run, bitwise; the
    fig 12 plan again from the cache; and the chunk kernel's time per tick
    as one group's K grows."""
    import shutil

    from repro_torch.analysis import plans as suites

    rp = reference_plan_script()
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    dist = reference_seeds(PLAN_SEEDS)
    out, plans = {}, {}
    for algo in ("reno", "dcqcn"):
        plans[f"fig10-{algo}"] = (suites.fig10_plan(algo, PLAN_SIM_TIME,
                                                    PLAN_SEEDS), 2, {})
    shutil.rmtree(PLAN_CACHE, ignore_errors=True)
    plans["fig12"] = (suites.fig12_plan(PLAN_SIM_TIME, PLAN_SEEDS), 2,
                      dict(cache_dir=PLAN_CACHE))
    results = {}
    for name, (plan, max_groups, kw) in plans.items():
        predicted = predicted_groups(plan)
        pr, seconds, counts = counted(
            kern, lambda: netsim.run_plan(plan, device=DEVICE, **kw))
        info = check_plan(pr, counts, max_groups)
        check_prediction(name, predicted, pr.n_compile_groups)
        if name.startswith("fig10") and (
                info["n_compile_groups"] != 2
                or any((g["k"], g["n_jobs"], g["n_flows"])
                       != (5 * len(PLAN_SEEDS), 6, 12)
                       for g in info["groups"])):
            raise AssertionError(f"{name}: groups {info['groups']}, "
                                 f"expected two of K={5 * len(PLAN_SEEDS)} "
                                 f"on 6 jobs x 2 flows")
        cells = plan_cells(netsim, pr)
        paired = rp.seed_columns(cells, PLAN_SEEDS, PAIRED_SEEDS)
        results[name] = pr
        out[name] = dict(seconds=seconds,
                         us_per_tick=1e6 * seconds / info["ticks"],
                         groups_predicted=predicted, **info, cells=cells,
                         tier_b=tier_b(name, paired, ref, PAIRED_SEEDS))
    # fig 10 Reno 6 jobs, p99, against the reference's seeds 1-3
    out["fig10_reno_6_jobs_p99"] = seed_spread(
        "fig10-reno", rp.seed_columns(out["fig10-reno"]["cells"],
                                      PLAN_SEEDS, PAIRED_SEEDS),
        ref, "6", "p99_speedup",
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
    out["reference_source"] = [os.path.relpath(p, ROOT)
                               for p in (REFERENCE_PLANS, REFERENCE_SEEDS)]
    out["outside_tolerance"] = [dict(plan=name, **o) for name in plans
                                for o in out[name]["tier_b"]["outside"]]
    out["distribution"] = distribution(
        rp.distribution_check({n: out[n]["cells"] for n in plans},
                              {n: dist["plans"][n]["cells"] for n in plans}),
        PLAN_SEEDS, named=[("fig10-reno", "6", "p99_speedup")],
        outside=out["outside_tolerance"])
    emit("plans", **out)
    check_distribution("plans", out["distribution"])
    return out


# ---------------------------------------------------------------------------
# the paper's other figure plans
# ---------------------------------------------------------------------------

# the suites' REPRO_SMOKE depth, at seeds 1-32 as the fig 10 and fig 12
# plans (PLAN_SEEDS; the paired checks read seeds 1-3)
FIGURE_SIM_TIME = 1.5
FIGURE_SEEDS = PLAN_SEEDS
# each figure's entry in results/benchmarks.json (the JAX reference's
# suites, seed 1, REPRO_SMOKE)
FIGURE_RECORDED = {"fig7-9": "fig7_9_convergence",
                   "table2": "fig11_table2_diversity",
                   "fig13": "fig13_partial_compat",
                   "fig14": "fig14_circular_dependency",
                   "fig15": "fig15_agg_functions",
                   "fig16": "fig16_slope_intercept",
                   "fig17": "fig17_wi_vs_md"}
# the metrics of each figure plan's cells that the figures phase holds to
# the reference's (tier_b); kernel_sweep reports only timings
FIGURE_METRICS = {
    "fig7-9": ("avg_speedup", "p99_speedup", "baseline_interleave",
               "mltcp_interleave", "converged_at_iter",
               "baseline_drops_per_s", "mltcp_drops_per_s",
               "baseline_marks_per_s", "mltcp_marks_per_s"),
    "table2": ("avg_speedup", "p99_speedup", "vs_ideal"),
    "fig13": ("mlqcn_avg", "mlqcn_p99", "static_avg", "static_p99"),
    "fig14": ("avg_speedup", "p99_speedup", "interleave"),
    "fig15": ("avg_speedup", "p99_speedup", "interleave"),
    "fig16": ("avg_speedup", "p99_speedup"),
    "fig17": ("avg_speedup", "p99_speedup"),
}


def figure_means(cells: dict) -> dict:
    """Each cell's metrics as the mean over its seeds (None where a seed
    has none), the suites' own aggregation."""
    return {cell: {m: (None if None in v else statistics.mean(v))
                   for m, v in c.items()} for cell, c in cells.items()}


def f1_equals_linear(kern, netsim, plan) -> dict:
    """fig 15's F1 group against the same points as Reno WI under the
    linear F of slope 1.75 and intercept 0.25, both through the chunk
    kernel: the same formula, so every leaf equal bit for bit."""
    import dataclasses

    from repro_torch.netsim import experiment

    points, cfgs, overrides, groups = experiment.resolve_plan(plan)
    group = next(g for g in groups if points[g.idxs[0]]["scheme"] == "F1")
    sweep = experiment.group_sweep(cfgs, overrides, group, device=DEVICE)
    if not (bool((sweep.slope == 1.75).all())
            and bool((sweep.intercept == 0.25).all())):
        raise AssertionError("fig 15's F1 group is not at Reno WI's slope "
                             "1.75 and intercept 0.25")
    linear = dataclasses.replace(group.cfg, protocol=dataclasses.replace(
        group.cfg.protocol, f_spec="linear", slope=1.75, intercept=0.25))
    runs = {}
    for name, cfg in (("F1", group.cfg), ("linear", linear)):
        raw, seconds, counts = run_counted(kern, cfg, sweep)
        check_counts(f"fig15 {name}", cfg, counts)
        runs[name] = (raw, seconds)
    err, n_leaves = compare_trees(runs["F1"][0], runs["linear"][0],
                                  what="F1 != linear(1.75, 0.25)")
    return dict(k=len(group.idxs), ticks=ticks_run(group.cfg), bitwise=True,
                leaves=n_leaves, max_abs_err=err,
                seconds={k: v[1] for k, v in runs.items()})


def kernel_sweep_turns(kern, netsim, suites) -> dict:
    """The kernel_sweep plan's group (Reno WI, 2 and 3 jobs x seeds 1-3,
    padded into one) on the chunk kernel at FIGURE_SIM_TIME and on the
    per-tick path (its plain version, graphed: the reference suite's
    "oracle" mode) at PER_TICK_SIM_TIME, in turns (per-tick, chunk, chunk,
    per-tick): µs per tick of each and their ratio."""
    from repro_torch.netsim import experiment

    turns = []
    for per_tick in (True, False, False, True):
        sim_time = PER_TICK_SIM_TIME if per_tick else FIGURE_SIM_TIME
        points, cfgs, overrides, groups = experiment.resolve_plan(
            suites.kernel_sweep_plan(sim_time, PAIRED_SEEDS))
        (group,) = groups
        sweep = experiment.group_sweep(cfgs, overrides, group, device=DEVICE)
        _, seconds, counts = run_counted(kern, group.cfg, sweep,
                                         per_tick=per_tick)
        check_counts("kernel_sweep turn", group.cfg, counts,
                     per_tick=per_tick)
        turns.append(dict(path="per_tick" if per_tick else "chunk",
                          k=len(group.idxs), ticks=ticks_run(group.cfg),
                          seconds=seconds, launches=counts,
                          us_per_tick=1e6 * seconds / ticks_run(group.cfg)))
    med = {path: statistics.median(t["us_per_tick"] for t in turns
                                   if t["path"] == path)
           for path in ("chunk", "per_tick")}
    return dict(turns=turns, chunk_us_per_tick=med["chunk"],
                per_tick_us_per_tick=med["per_tick"],
                per_tick_over_chunk=med["per_tick"] / med["chunk"])


def excused_idle(pr, paired, anywhere) -> list:
    """[point label, job] of the port's run that `check_plan` lets record
    no iteration: at seeds 1-3 what the reference's run leaves idle at the
    same seed (``paired``, reference_plans.json's ``idle_jobs``); at
    another seed a job that the reference leaves idle in the same cell at
    any of its seeds 1-32 (``anywhere``, reference_seeds.json's): which
    seeds those are is chaos (Table 2's roberta beside camembert)."""
    def cell(label):
        return ",".join(p for p in label.split(",")
                        if not p.startswith("seed="))
    idle_cells = {(cell(label), j) for label, j in anywhere}
    return [list(pair) for pair in paired] + [
        [r.point.label(), j] for r in pr
        if r.point["seed"] not in PAIRED_SEEDS
        for j in range(len(r.iter_times))
        if (cell(r.point.label()), j) in idle_cells]


def phase_figures(kern, core, netsim, workload) -> dict:
    """The paper's other figure plans (`analysis.plans.FIGURES`: figs 7-9,
    Table 2, figs 13-17, kernel_sweep) through `netsim.run_plan` on the
    card at the suites' 1.5 s and seeds 1-32, each counted on its own: the
    plan lint's groups, every group on the chunk kernel (one launch a chunk,
    no per-tick launch, no fallback; fig 15's F1..F6 groups among them),
    the suites' own group assertions; at seeds 1-3 each cell against the
    reference's (Tier B) and the paper's claims, failing only where the
    reference holds one at the same seed; at seeds 1-32 every cell and
    claim against the reference's distribution (`distribution_check`,
    which fails the phase after its line on a rejected row); F1 against
    linear(1.75, 0.25), bit for bit; and kernel_sweep's two paths in
    turns."""
    from repro_torch.analysis import plans as suites

    t0 = time.time()
    rp = reference_plan_script()
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    dist = reference_seeds(FIGURE_SEEDS)
    with open(os.path.join(ROOT, "results", "benchmarks.json")) as f:
        recorded = json.load(f)
    out, summary, port_claims = {}, {}, {}
    for name, build in suites.FIGURES.items():
        plan = build(FIGURE_SIM_TIME, FIGURE_SEEDS)
        predicted = predicted_groups(plan)
        pr, seconds, counts = counted(
            kern, lambda: netsim.run_plan(plan, device=DEVICE))
        lo, hi = rp.SUITE_GROUPS.get(name, (predicted, predicted))
        idle = excused_idle(
            pr, ref["plans"].get(name, {}).get("idle_jobs", ()),
            dist["plans"].get(name, {}).get("idle_jobs", ()))
        info = check_plan(pr, counts, hi, idle)
        check_prediction(name, predicted, pr.n_compile_groups)
        if info["n_compile_groups"] < lo:
            raise AssertionError(f"{name}: {info['n_compile_groups']} "
                                 f"groups, the suite's {lo}-{hi}")
        row = dict(seconds=seconds, us_per_tick=1e6 * seconds / info["ticks"],
                   groups_predicted=predicted, **info)
        if name in ref["plans"]:
            want = ref["plans"][name]
            if info["n_compile_groups"] != want["n_compile_groups"]:
                raise AssertionError(f"{name}: {info['n_compile_groups']} "
                                     f"groups, the reference "
                                     f"{want['n_compile_groups']}")
            cells = rp.figure_cells(name, netsim, workload, pr)
            feasible = (bool(suites.fig14_schedule()[1]) if name == "fig14"
                        else None)
            port_claims[name] = rp.figure_claims(name, cells, feasible)
            paired = rp.seed_columns(cells, FIGURE_SEEDS, PAIRED_SEEDS)
            claims = rp.figure_claims(name, paired, feasible)
            ref_claims = rp.figure_claims(name, want["cells"],
                                          want.get("cassini_has_schedule"))
            unheld = [(c, PAIRED_SEEDS[i])
                      for c, i in rp.unshared_claims(claims, ref_claims)]
            if unheld:
                raise AssertionError(f"{name}: claims the reference holds "
                                     f"fail on the port at seeds: {unheld}")
            row.update(
                cells=cells, means=figure_means(cells),
                reference_means=figure_means(dist["plans"][name]["cells"]),
                recorded=recorded.get(FIGURE_RECORDED[name]),
                claims=claims, reference_claims=ref_claims,
                failed_in_both=[(c, PAIRED_SEEDS[i])
                                for c, held in claims.items()
                                for i, h in enumerate(held)
                                if not h and not ref_claims[c][i]],
                tier_b=tier_b(name, paired, ref, PAIRED_SEEDS,
                              FIGURE_METRICS[name]))
            if name == "fig14":
                row["cassini_has_schedule"] = feasible
        out[name] = row
        summary[name] = dict(
            seconds=seconds, us_per_tick=row["us_per_tick"],
            us_per_group_tick=row["us_per_tick"] / info["n_compile_groups"],
            groups=info["n_compile_groups"], predicted=predicted,
            k=[g["k"] for g in info["groups"]],
            us_per_point_tick=[g["us_per_point_tick"]
                               for g in info["groups"]],
            launches=counts["netsim_chunk"])
    out["f1_equals_linear"] = f1_equals_linear(
        kern, netsim, suites.fig15_plan(FIGURE_SIM_TIME, FIGURE_SEEDS))
    out["kernel_sweep_turns"] = kernel_sweep_turns(kern, netsim, suites)
    out["summary"] = summary
    out["outside_tolerance"] = [dict(plan=name, **o) for name in ref["plans"]
                                if name in out and "tier_b" in out[name]
                                for o in out[name]["tier_b"]["outside"]]
    out["distribution"] = distribution(
        rp.distribution_check(
            {n: out[n]["cells"] for n in port_claims},
            {n: dist["plans"][n]["cells"] for n in port_claims},
            port_claims=port_claims,
            ref_claims={n: dist["plans"][n]["claims"] for n in port_claims}),
        FIGURE_SEEDS, named=[("fig7-9", "cubic", "converged_at_iter"),
                             ("fig7-9", "cubic", "mltcp_interleave")],
        outside=out["outside_tolerance"])
    out["seconds"] = time.time() - t0
    emit("figures", **out)
    check_distribution("figures", out["distribution"])
    return out


# ---------------------------------------------------------------------------
# telemetry and faults: the fig 5 timeline and the churn gauntlet plans
# ---------------------------------------------------------------------------

# the timeline suite (repro_torch/figures/timeline.py) at REPRO_SMOKE depth
# (common.SIM_TIME), seeds 1-3
FIG5_SIM_TIME = 1.5
FIG5_SEEDS = (1, 2, 3)
FIG5_METRICS = ("tti_iters", "tti_seconds", "interleave_stability",
                "p50_iter_s", "p99_iter_s")
# the churn suite (repro_torch/figures/churn.py) at its own depth
# (churn.SIM_TIME, 18 s x WORK_SCALE), seeds 1-3
CHURN_SEEDS = (1, 2, 3)
CHURN_METRICS = ("interleave_stability", "max_reinterleave_iters")


def reference_plan_script():
    """scripts/reference_plans.py as a module: the figure plans' cells
    (`figure_cells`, read from a PlanResult of either package through the
    netsim accessors), the paper's claims on them (`figure_claims`,
    `unshared_claims`), the suites' group limits (`SUITE_GROUPS`) and the
    jobs a point runs (`active_jobs`); it imports nothing of the reference
    until its main runs."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import reference_plans
    return reference_plans


def fig5_claims(cells: dict) -> dict:
    """The timeline suite's assertions per algorithm
    (`timeline._failures`) on {algo/variant: per-seed values}: every MLTCP
    seed interleaves within `timeline.MAX_TTI_ITERS` iterations, no
    baseline seed converges; each algorithm's failed messages."""
    from repro_torch.figures import timeline

    def iters(xs):
        return [float("inf") if x is None else x for x in xs]
    out = {}
    for algo in timeline.SOCKETS:
        ml, base = cells[f"{algo}/WI"], cells[f"{algo}/OFF"]
        out[algo] = dict(tti_iters=ml["tti_iters"], failed=timeline._failures(
            algo, iters(ml["tti_iters"]), base["converged"],
            iters(base["tti_iters"])))
    return out


def armed_turns(kern, core, netsim, workload) -> dict:
    """fig7-reno WI at 1.5 s (K = 2 seeds) unarmed and with the fig 5
    spec armed, in turns (unarmed, armed, armed, unarmed): µs per tick."""
    import dataclasses

    from repro_torch.analysis import plans as suites

    base = fig7_cfg(core, netsim, workload, "reno", 1, MAIN_SIM_TIME)
    cfgs = {"unarmed": base,
            "armed": dataclasses.replace(
                base, telemetry=suites.fig5_spec(FIG5_SIM_TIME))}
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
    from repro_torch.analysis import plans as suites

    rp = reference_plan_script()
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    want = ref["plans"]["fig5"]
    plan = suites.fig5_plan(FIG5_SIM_TIME, FIG5_SEEDS)
    spec = suites.fig5_spec(FIG5_SIM_TIME)
    predicted = predicted_groups(plan, spec)
    pr, seconds, counts = counted(kern, lambda: netsim.run_plan(
        plan, device=DEVICE, telemetry=spec))
    info = check_plan(pr, counts, want["n_compile_groups"])
    check_prediction("fig5", predicted, pr.n_compile_groups)
    if info["n_compile_groups"] != want["n_compile_groups"]:
        raise AssertionError(f"fig5: {info['n_compile_groups']} groups, the "
                             f"reference {want['n_compile_groups']}")
    cells = rp.timeline_cells(netsim, pr)
    claims = fig5_claims(cells)
    failed = {a: c["failed"] for a, c in claims.items() if c["failed"]}
    if failed:
        raise AssertionError(f"fig5: the suite's assertions fail: {failed}")
    out = dict(seconds=seconds, us_per_tick=1e6 * seconds / info["ticks"],
               groups_predicted=predicted, **info, cells=cells, claims=claims,
               reference_claims=fig5_claims(want["cells"]),
               tier_b=tier_b("fig5", cells, ref, FIG5_SEEDS, FIG5_METRICS),
               sketch=sketch_check(kern["nc"], netsim),
               fig7_reno=armed_turns(kern, core, netsim, workload))
    emit("telemetry", **out)
    return out


def churn_window_names(label: str) -> dict:
    """churn._window_names on the gauntlet's fabric at churn.SIM_TIME:
    start tick -> window name."""
    from repro_torch.analysis import plans as suites
    from repro_torch.figures import churn

    cfg = suites.churn_plan(churn.SIM_TIME, CHURN_SEEDS[:1]).build(
        dict(algo="reno", variant="WI", schedule=label, seed=1))
    return churn._window_names(cfg, label)


def churn_claims(cells: dict) -> dict:
    """The churn suite's assertions (`churn._failures`) per (algo,
    schedule) on {algo/variant/schedule: per-seed reports}: after every
    non-exempt fault window MLTCP re-interleaves within
    `churn.MAX_REINTERLEAVE_ITERS` iterations (worst over seeds), every
    required window is seen, MLTCP stability holds, no baseline run
    re-converges from every window, and the baseline's stability sits
    below MLTCP's by the algorithm's margin.  Each failure names its kind
    and, for the first two, its windows."""
    from repro_torch.figures import churn

    out = {}
    for algo in churn.SOCKETS:
        for label in churn.SCHEDULES:
            ml = cells[f"{algo}/WI/{label}"]
            base = cells[f"{algo}/OFF/{label}"]
            names = churn_window_names(label)
            worst = churn._worst([
                [dict(window=names.get(e["start_tick"],
                                       f"tick{e['start_tick']}"),
                      reinterleave_iters=e["reinterleave_iters"])
                 for e in events] for events in ml["events"]])
            ml_stab = min(ml["interleave_stability"])
            base_stab = max(base["interleave_stability"])
            out[f"{algo}/{label}"] = dict(
                worst_reinterleave_iters={k: (None if v == float("inf")
                                              else v)
                                          for k, v in worst.items()},
                ml_stability=ml_stab, baseline_stability=base_stab,
                failed=churn._failures(algo, label, worst, ml_stab,
                                       base_stab,
                                       any(base["all_events_reconverged"])))
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
    from repro_torch.analysis import plans as suites
    from repro_torch.figures import churn

    rp = reference_plan_script()
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    want = ref["plans"]["churn"]
    plan = suites.churn_plan(churn.SIM_TIME, CHURN_SEEDS)
    predicted = predicted_groups(plan)
    pr, seconds, counts = counted(
        kern, lambda: netsim.run_plan(plan, device=DEVICE))
    info = check_plan(pr, counts, want["n_compile_groups"])
    check_prediction("churn", predicted, pr.n_compile_groups)
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
                 if name not in churn._EXEMPT and v is not None),
                default=None)
    out = dict(seconds=seconds, us_per_tick=1e6 * seconds / info["ticks"],
               groups_predicted=predicted, **info, cells=cells, claims=claims,
               reference_claims=ref_claims,
               worst_reinterleave_iters=worst,
               tier_b=tier_b("churn", cells, ref, CHURN_SEEDS,
                             CHURN_METRICS))
    emit("faults", **out)
    return out


# the figure plans whose CC specializations the armed kernel took only as
# launch dims: fig 17 (Reno and CUBIC x OFF / WI / MD) and fig 13 (Static
# factors against MLQCN on DCQCN)
ARMED_PLANS = ("fig17", "fig13")


def phase_armed_plans(kern, netsim) -> dict:
    """Fig 17's and fig 13's plans (`analysis.plans.FIGURES`) at the
    figures phase's depth and seeds 1-3 through `run_plan` on the card,
    unarmed and then
    with the fig 5 spec armed, each counted: the plan lint's groups, one
    launch a chunk, no per-tick launch and no fallback, and every
    non-telemetry leaf of every point of the armed run bitwise equal to
    the unarmed run's (arming changes nothing); µs per tick of both."""
    from repro_torch.analysis import plans as suites

    spec = suites.fig5_spec(FIGURE_SIM_TIME)
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    out = {}
    for name in ARMED_PLANS:
        plan = suites.FIGURES[name](FIGURE_SIM_TIME, PAIRED_SEEDS)
        idle = ref["plans"].get(name, {}).get("idle_jobs", ())
        runs, row = {}, {}
        for arm, tel in (("unarmed", None), ("armed", spec)):
            predicted = predicted_groups(plan, tel)
            pr, seconds, counts = counted(kern, lambda: netsim.run_plan(
                plan, device=DEVICE, telemetry=tel))
            info = check_plan(pr, counts, predicted, idle)
            check_prediction(f"{name} {arm}", predicted, pr.n_compile_groups)
            if (tel is None) != all(r.telemetry is None for r in pr):
                raise AssertionError(f"{name} {arm}: telemetry on the "
                                     f"results does not match the run")
            runs[arm] = pr
            row[arm] = dict(seconds=seconds,
                            us_per_tick=1e6 * seconds / info["ticks"],
                            groups_predicted=predicted, **info)
        if not same_results(runs["unarmed"].results, runs["armed"].results):
            raise AssertionError(f"{name}: arming telemetry changed a "
                                 f"non-telemetry leaf")
        row.update(bitwise_unarmed=True, armed_over_unarmed=(
            row["armed"]["us_per_tick"] / row["unarmed"]["us_per_tick"]))
        out[name] = row
    emit("armed_plans", sim_time=FIGURE_SIM_TIME, seeds=PAIRED_SEEDS,
         spec=dict(probes=list(spec.probes), stride=spec.stride,
                   detectors=list(spec.detectors)), **out)
    return out


# ---------------------------------------------------------------------------
# the paper-figure harness: every suite of repro_torch.figures
# ---------------------------------------------------------------------------

# the suites' REPRO_SMOKE depth (1.5 s, seed 1; the churn suite its own
# 4.5 s at seeds 1-3, the seeds of the reference's verdicts)
SUITE_SMOKE = dict(REPRO_SMOKE="1", REPRO_FULL="0")
CHURN_SUITE_SEEDS = (1, 2, 3)
# the health every suite must show
SUITE_HEALTH_ZERO = ("n_kernel_fallbacks", "n_group_mispredicts",
                     "n_group_errors", "n_budget_mismatches")


@contextlib.contextmanager
def environment(**values):
    """``os.environ`` with ``values`` set for the block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def key_tree(d):
    """A derived dict's nested keys (its values' types aside)."""
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def suite_cells(name: str, derived: dict) -> list:
    """[(reference plan, cells, metrics)] of one suite's derived dict at
    seed 1, in the layout of results/reference_plans.json (each metric a
    one-value list; None for a value that is not finite), for the metrics
    the plans, figures and telemetry phases hold to the reference."""
    rp = reference_plan_script()

    def one(x):
        return [rp.finite(x) if x is not None else None]

    def cells_of(pairs):
        return {cell: {m: one(v) for m, v in metrics.items()}
                for cell, metrics in pairs}
    if name == "fig5_timeline":
        return [("fig5", cells_of(
            (f"{algo}/WI", {m: derived[algo][m] for m in FIG5_METRICS})
            for algo in derived if algo != "_profile"), FIG5_METRICS)]
    if name == "fig7_9_convergence":
        metrics = ("avg_speedup", "p99_speedup", "baseline_interleave",
                   "mltcp_interleave", "converged_at_iter")
        return [("fig7-9", cells_of(
            (algo, {m: c[m] for m in metrics})
            for algo, c in derived.items()), metrics)]
    if name == "fig10_speedup_vs_jobs":
        out = []
        for algo in ("reno", "dcqcn"):
            out.append((f"fig10-{algo}", cells_of(
                (key.split("_")[1][:-len("jobs")],
                 {m: c[m] for m in ("avg_speedup", "p99_speedup")})
                for key, c in derived.items()
                if key.startswith(f"{algo}_")),
                ("avg_speedup", "p99_speedup")))
        return out
    if name == "fig11_table2_diversity":
        metrics = ("avg_speedup", "p99_speedup", "vs_ideal")
        return [("table2", cells_of(
            (snap, {m: c[m] for m in metrics})
            for snap, c in derived.items()), metrics)]
    if name == "fig12_stragglers":
        return [("fig12", cells_of(
            (f"{scheme}@{key[len('p='):]}",
             {"avg_speedup": c[f"{scheme}_avg"],
              "p99_speedup": c[f"{scheme}_p99"]})
            for key, c in derived.items()
            for scheme in ("mlqcn", "cassini")),
            ("avg_speedup", "p99_speedup"))]
    if name == "fig13_partial_compat":
        return [("fig13", cells_of(derived.items()),
                 FIGURE_METRICS["fig13"])]
    if name == "fig14_circular_dependency":
        d = derived
        return [("fig14", cells_of((
            ("base", {"interleave": d["base_interleave"]}),
            ("mlqcn", {"avg_speedup": d["mlqcn_avg_speedup"],
                       "p99_speedup": d["mlqcn_p99_speedup"],
                       "interleave": d["mlqcn_interleave"]}),
            ("cassini", {"avg_speedup": d["cassini_avg_speedup"]}))),
            FIGURE_METRICS["fig14"])]
    if name == "fig15_agg_functions":
        return [("fig15", cells_of(
            (f, {"avg_speedup": c["avg_speedup"],
                 "interleave": c["interleave"]})
            for f, c in derived.items()), ("avg_speedup", "interleave"))]
    if name in ("fig16_slope_intercept", "fig17_wi_vs_md"):
        plan = "fig16" if name.startswith("fig16") else "fig17"
        return [(plan, cells_of(
            (cell, {m: c[m] for m in ("avg_speedup", "p99_speedup")})
            for cell, c in derived.items() if cell != "best"),
            ("avg_speedup", "p99_speedup"))]
    return []                                   # kernel_sweep: timings


def churn_values(derived: dict, ref: dict) -> dict:
    """The churn suite's numbers (over seeds 1-3) against the reference
    suite's verdicts at the same seeds (results/reference_plans.json,
    ``plans.churn.assertions``): MLTCP's least and the baseline's greatest
    stability within the faults phase's interleave_stability tolerance,
    each window's worst re-interleave iterations within its
    max_reinterleave_iters tolerance; more than half of a metric's values
    outside fails."""
    plan = ref["plans"]["churn"]
    tol = {m: plan_tolerance(plan, m) for m in CHURN_METRICS}
    rows = []
    for cell, d in derived.items():
        if cell.startswith("_"):
            continue
        want = plan["assertions"][cell]
        for key in ("ml_stability", "baseline_stability"):
            rows.append((cell, key, "interleave_stability", d[key],
                         want[key]))
        for window, got in d["worst_reinterleave_iters"].items():
            rows.append((cell, window, "max_reinterleave_iters", got,
                         want["worst"].get(window)))
    outside = []
    for metric in CHURN_METRICS:
        mine = [r for r in rows if r[2] == metric]
        bad = [dict(cell=cell, value=key, port=got, reference=want,
                    tolerance=tol[metric])
               for cell, key, _, got, want in mine
               if not ((got is None and want is None) or (
                   got is not None and want is not None
                   and abs(got - want) <= tol[metric]))]
        outside += bad
        if 2 * len(bad) > len(mine):
            raise AssertionError(f"churn suite: {len(bad)} of {len(mine)} "
                                 f"values outside the {metric} tolerance: "
                                 f"{bad}")
    return dict(tolerance=tol, values=len(rows), outside=outside)


def oracle_equals_fused(oracle, fused) -> dict:
    """kernel_sweep's two modes at the same depth: every point's iteration
    counts and iteration times (and the rest of its SimResult's arrays)
    bit for bit, the chunk kernel being bitwise with the per-tick path."""
    import numpy as np

    if len(oracle.results) != len(fused.results):
        raise AssertionError("kernel_sweep: the modes ran different points")
    iterations = 0
    for i, (a, b) in enumerate(zip(oracle.results, fused.results)):
        if a.cfg.jobs.n_jobs != b.cfg.jobs.n_jobs:
            raise AssertionError(f"kernel_sweep: point {i} has "
                                 f"{a.cfg.jobs.n_jobs} jobs beside "
                                 f"{b.cfg.jobs.n_jobs}")
        arrays = [(f"iter_times[{j}]", x, y)
                  for j, (x, y) in enumerate(zip(a.iter_times, b.iter_times))]
        arrays += [(f, getattr(a, f), getattr(b, f))
                   for f in ("trace_t", "trace_util", "trace_incomm",
                             "trace_drops", "trace_jobtput")]
        for what, x, y in arrays:
            if (x.shape != y.shape or x.dtype != y.dtype
                    or x.tobytes() != y.tobytes()):
                raise AssertionError(f"kernel_sweep point {i}: the "
                                     f"oracle's {what} differs from the "
                                     f"fused mode's")
        if (a.drops_per_s, a.marks_per_s) != (b.drops_per_s, b.marks_per_s):
            raise AssertionError(f"kernel_sweep point {i}: drops or marks "
                                 f"differ")
        iterations += sum(len(x) for x in a.iter_times)
    return dict(points=len(oracle.results), iterations=iterations,
                ticks=ticks_run(oracle.results[0].cfg), bitwise=True)


def phase_suites(kern, core, netsim, workload) -> dict:
    """Every suite of `repro_torch.figures` (the port of ``benchmarks/``)
    run in-process as ``python -m repro_torch.figures`` runs it
    (`common.timed`, `common.merge_results` into a temporary file), at
    REPRO_SMOKE depth, each counted on its own: every group of every
    suite on the chunk kernel (one launch a chunk, no per-tick launch but
    kernel_sweep's oracle, no fallback; the oracle graphed at the suite's
    own depth, each of its points bit for bit equal to the fused mode's:
    `oracle_equals_fused`); the suite's ``_health``
    with no fallback, mispredict, group error or budget mismatch; its
    derived keys equal to the reference's recorded entry
    (results/benchmarks.json); its values at seed 1 against the
    reference's (Tier B, the existing phases' tolerances); its own
    assertions held.  The churn suite runs at seeds 1-3: ``churn.run()``
    must raise the Reno re-interleave assertion the reference raises
    there, every failure shared with the reference, and
    ``churn.run(algos=("cubic", "dcqcn"))`` must hold."""
    import shutil
    import tempfile

    from repro_torch.figures import churn, common, kernel_sweep, timeline
    from repro_torch.figures.__main__ import SUITES

    t0 = time.time()
    rp = reference_plan_script()
    with open(REFERENCE_PLANS) as f:
        ref = json.load(f)
    with open(os.path.join(ROOT, "results", "benchmarks.json")) as f:
        recorded = json.load(f)
    tmp = tempfile.mkdtemp(prefix="suites-")
    results_path = os.path.join(tmp, "figures_torch.json")
    ran = []
    run_plan = common.run_plan

    def recording(plan, **kw):
        pr = run_plan(plan, **kw)
        ran.append(pr)
        return pr

    def suite(name, fn):
        """(BenchResult, seconds, counts, plan results) of one suite."""
        ran.clear()
        r, seconds, counts = counted(kern, lambda: common.timed(name, fn))
        return r, seconds, counts, list(ran)

    def check_route(name, counts, prs, oracle=None):
        want = dict(netsim_chunk=sum(pr.n_compile_groups
                                     * n_chunks_run(pr.results[0].cfg)
                                     for pr in prs),
                    mltcp_step=0, fallbacks=0, chunk_fallbacks=0, **NO_GRAPH)
        if oracle is not None:
            # the oracle's warm-up and timed runs on the graphed path
            graphed = expected_counts(oracle, "graph")
            for k in ("mltcp_step", "graph_captures", "graph_replays"):
                want[k] = 2 * graphed[k]
        if counts != want:
            raise AssertionError(f"suite {name}: launches and fallbacks "
                                 f"{counts}, expected {want}")
        return want

    def check_health(name, health):
        bad = {k: health[k] for k in SUITE_HEALTH_ZERO if health[k]}
        if bad:
            raise AssertionError(f"suite {name}: _health {bad}")

    oracles = []
    per_tick = kernel_sweep._per_tick

    def recording_oracle(plan, **kw):
        pr = per_tick(plan, **kw)
        oracles.append(pr)
        return pr

    out, summary = {}, {}
    timelines_dir = timeline.TIMELINES_DIR
    common.run_plan = recording
    kernel_sweep._per_tick = recording_oracle
    timeline.TIMELINES_DIR = os.path.join(tmp, "timelines")
    try:
        with environment(**SUITE_SMOKE), \
                common.at_depth(**common.depth(full=False, smoke=True)):
            for name, fn in SUITES:
                if name == "churn_gauntlet":
                    continue
                r, seconds, counts, prs = suite(name, fn)
                common.merge_results({name: {**r.derived,
                                             "_health": r.health}},
                                     results_path)
                print(r.csv_line(), flush=True)
                oracle = None
                if name == "kernel_sweep":
                    oracle = oracles[-1].results[0].cfg
                    if (r.derived["interpret"] or r.derived["kernel_fallbacks"]
                            or oracle.sim_time != prs[-1].results[0].cfg.sim_time):
                        raise AssertionError(f"kernel_sweep: {r.derived}")
                want = check_route(name, counts, prs, oracle)
                check_health(name, r.health)
                row = dict(csv=r.csv_line(), seconds=seconds,
                           suite_wall_s=r.wall_s, n_ticks=r.n_ticks,
                           us_per_tick=1e6 * r.wall_s / max(r.n_ticks, 1),
                           groups=[pr.n_compile_groups for pr in prs],
                           launches=counts, expected=want, health=r.health)
                if name in recorded:
                    if key_tree(r.derived) != key_tree(recorded[name]):
                        raise AssertionError(
                            f"suite {name}: keys {key_tree(r.derived)}, the "
                            f"reference's {key_tree(recorded[name])}")
                    row["keys_equal_recorded"] = True
                if name == "fig14_circular_dependency":
                    want_cas = ref["plans"]["fig14"]["cassini_has_schedule"]
                    if r.derived["cassini_has_schedule"] != want_cas:
                        raise AssertionError("fig14: cassini_has_schedule "
                                             f"{r.derived} != {want_cas}")
                row["tier_b"] = {plan: tier_b(plan, cells, ref, (1,),
                                              metrics)
                                 for plan, cells, metrics
                                 in suite_cells(name, r.derived)}
                row["derived"] = r.derived
                if name == "kernel_sweep":
                    row["oracle_equals_fused"] = oracle_equals_fused(
                        oracles[-1], prs[-1])
                out[name] = row
                summary[name] = dict(seconds=seconds,
                                     us_per_tick=row["us_per_tick"],
                                     groups=sum(row["groups"]),
                                     launches=counts["netsim_chunk"],
                                     oracle_launches=counts["mltcp_step"])
            # the churn suite at the reference's verdict seeds: all three
            # algorithms raise Reno's bound, as the reference does
            with common.at_depth(SEEDS=CHURN_SUITE_SEEDS):
                ran.clear()
                t_all = time.time()
                try:
                    counted(kern, lambda: common.timed("churn_gauntlet",
                                                       churn.run))
                except AssertionError as exc:
                    raised = str(exc)
                    all_seconds = time.time() - t_all
                else:
                    raise AssertionError("churn.run() held every assertion; "
                                         "the reference fails Reno's "
                                         "re-interleave bound")
                (pr,) = ran
                # the counts `counted` set to 0 before the run that raised
                all_launches = check_route(
                    "churn_gauntlet (all algorithms)", read_counts(kern), ran)
                claims = churn_claims(rp.churn_cells(netsim, pr))
                ref_claims = churn_claims(ref["plans"]["churn"]["cells"])
                unshared = {cell: bad for cell, c in claims.items()
                            if (bad := unshared_failures(c,
                                                         ref_claims[cell]))}
                first = claims["reno/gauntlet"]["failed"]
                if (unshared or not first or first[0]["kind"]
                        != "reinterleave" or raised != first[0]["msg"]):
                    raise AssertionError(
                        f"churn.run() raised {raised!r}; the port's "
                        f"failures not shared with the reference: "
                        f"{unshared}; reno/gauntlet: {first}")
                r, seconds, counts, prs = suite(
                    "churn_gauntlet",
                    lambda: churn.run(algos=("cubic", "dcqcn")))
                common.merge_results({"churn_gauntlet": {
                    **r.derived, "_health": r.health}}, results_path)
                print(r.csv_line(), flush=True)
                want = check_route("churn_gauntlet", counts, prs)
                check_health("churn_gauntlet", r.health)
                out["churn_gauntlet"] = dict(
                    raised=raised, all_algorithms=dict(
                        seconds=all_seconds, groups=pr.n_compile_groups,
                        launches=all_launches),
                    csv=r.csv_line(), seconds=seconds,
                    suite_wall_s=r.wall_s, n_ticks=r.n_ticks,
                    us_per_tick=1e6 * r.wall_s / max(r.n_ticks, 1),
                    groups=[p.n_compile_groups for p in prs],
                    launches=counts, expected=want, health=r.health,
                    values=churn_values(r.derived, ref), derived=r.derived)
                summary["churn_gauntlet"] = dict(
                    seconds=seconds,
                    us_per_tick=out["churn_gauntlet"]["us_per_tick"],
                    groups=sum(out["churn_gauntlet"]["groups"]),
                    launches=counts["netsim_chunk"])
        with open(results_path) as f:
            merged = sorted(json.load(f))
    finally:
        common.run_plan = run_plan
        kernel_sweep._per_tick = per_tick
        timeline.TIMELINES_DIR = timelines_dir
        shutil.rmtree(tmp, ignore_errors=True)
    if merged != sorted(name for name, _ in SUITES):
        raise AssertionError(f"merged suites {merged}")
    out["summary"] = summary
    out["outside_tolerance"] = [
        dict(suite=name, plan=plan, **o) for name, row in out.items()
        if "tier_b" in row for plan, tb in row["tier_b"].items()
        for o in tb["outside"]] + [
        dict(suite="churn_gauntlet", **o)
        for o in out["churn_gauntlet"]["values"]["outside"]]
    out["seconds"] = time.time() - t0
    emit("suites", **out)
    return out


# ---------------------------------------------------------------------------
# the static verifier's gate
# ---------------------------------------------------------------------------

def phase_analysis(kern) -> dict:
    """``repro_torch.analysis``'s gate on the card: `run_analysis` over the
    five CI plans under the ``ci`` profile, each group's accounting run
    (its first chunk) through the chunk kernel, the launch contract read
    from the library and every envelope checked against the committed
    ``analysis/budgets.json``; raises unless the report is ok.  Emits each
    plan's proof, the phase's seconds and the budget book it observed, as
    a baseline file holds it (what ``--update-budgets`` would write)."""
    import torch

    from repro_torch.analysis import CI_PLANS, run_analysis
    from repro_torch.analysis.budget import BudgetBook

    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    torch.cuda.synchronize()
    launches0 = (nc.LAUNCH_COUNT, ms.LAUNCH_COUNT,
                 ops.FALLBACK_COUNT + ops.CHUNK_FALLBACK_COUNT)
    t0 = time.time()
    book = BudgetBook()
    report = run_analysis(CI_PLANS, profile="ci", budgets=book)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = dict(netsim_chunk=nc.LAUNCH_COUNT - launches0[0],
                  mltcp_step=ms.LAUNCH_COUNT - launches0[1],
                  fallbacks=(ops.FALLBACK_COUNT + ops.CHUNK_FALLBACK_COUNT
                             - launches0[2]))
    proofs = {k: v for k, v in report.proofs.items() if k != "source"}
    out = dict(seconds=seconds, ok=report.ok(), profile=report.profile,
               proofs=proofs, source=report.proofs["source"],
               launches=counts,
               findings=[f for f in report.to_json()["findings"]
                         if f["severity"] != "info"],
               budgets=book.to_json())
    emit("analysis", **out)
    groups = sum(p["groups_predicted"] for p in proofs.values())
    bad = [(name, p) for name, p in proofs.items()
           if p["groups_run"] != p["groups_predicted"]
           or p["launches"] != p["groups_predicted"]
           or p["kernel_groups_proven"] != p["groups_predicted"]
           or p["kernel_fallbacks"] or p["spill_bytes"]]
    if (not report.ok() or bad or counts != dict(
            netsim_chunk=groups, mltcp_step=0, fallbacks=0)
            or proofs["fig13"]["groups_run"] > 2):
        raise AssertionError(f"analysis: {report.render()}\nplans {bad}, "
                             f"launches {counts} for {groups} groups")
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


def flash_bound(b, t, s, h, kv, dh, causal, window, dtype="float32"):
    """(bound_ms, bound_by, flop, bytes) of one flash launch from the
    kernel's own `cost` (q.k and p.v are 2·D flops each per unmasked pair;
    q, k, v read once and the output written once), the FLOP at the
    peak of ``dtype``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline.hw import H100

    dt = _tdtype(dtype)
    flop, nbytes = fa.cost(b, t, s, h, kv, dh, causal, window, dt)
    t_ops, t_bytes = flop / H100.peak_flops(dt), nbytes / hbm_bytes_per_s()
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


def rglru_bound(b, t, d):
    """(bound_ms, bound_by, bytes) of one float32 scan from the kernel's
    own `cost`: a and b read once, h written once; a multiply and an add
    each."""
    import torch

    from repro_torch.kernels import rg_lru as rl

    flop, nbytes = rl.cost(b, t, d, torch.float32)
    t_ops, t_bytes = flop / f32_ops_per_s(), nbytes / hbm_bytes_per_s()
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
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with traced(activities) as prof:
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
        backward_bound_ms=1e3 * bwd_bytes / hbm_bytes_per_s(),
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
        backward_bound_ms=1e3 * max(bwd_flop / f32_ops_per_s(),
                                    bwd_bytes / hbm_bytes_per_s()),
        backward_bound_by=("operations" if bwd_flop / f32_ops_per_s()
                           >= bwd_bytes / hbm_bytes_per_s() else "bytes"),
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
    and the chunk kernel, its launches counted alone, its runs held to
    the plan lint's prediction; raises on a fallback, a per-tick launch or
    a non-finite value."""
    import torch

    from repro_torch import cluster
    from repro_torch.cluster.runner import shared_cluster_plan
    from repro_torch.configs import get_config
    from repro_torch.netsim import counters

    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    profiles = {a: cluster.profile_from_arch(get_config(a))
                for a in dict.fromkeys(jobs)}
    predicted = predicted_groups(shared_cluster_plan(jobs))
    torch.cuda.synchronize()
    ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    t0 = time.time()
    with counters.watch() as w:
        rep = cluster.simulate_shared_cluster(jobs)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    check_prediction(f"shared-cluster {jobs}", predicted, w.traces)
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
        groups_predicted=predicted, groups_run=w.traces, seconds=seconds)


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


# ---------------------------------------------------------------------------
# the examples (repro_torch.examples), each as a user runs it
# ---------------------------------------------------------------------------

# (module, argv): each at its defaults, serve_lm for the model with both
# language-model kernels
EXAMPLES = (("interleave_demo", ()), ("simulate_cluster", ()),
            ("serve_lm", ("--arch", "recurrentgemma-2b")), ("quickstart", ()))


def run_example(kern, fa, rl, name: str, argv) -> tuple:
    """``repro_torch.examples.<name>.main(argv)`` on the card with every
    kernel's launches and the fallbacks counted from 0, timed on the host
    clock around a synchronized run, its printed lines captured and
    printed; returns (main's result, the row)."""
    import importlib
    import io

    import torch

    module = importlib.import_module(f"repro_torch.examples.{name}")
    ms, nc, ops = kern["ms"], kern["nc"], kern["ops"]
    torch.cuda.synchronize()
    ms.LAUNCH_COUNT = nc.LAUNCH_COUNT = fa.LAUNCH_COUNT = rl.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = ops.CHUNK_FALLBACK_COUNT = 0
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            out = module.main(list(argv))
        torch.cuda.synchronize()
    finally:
        print(buf.getvalue(), end="", flush=True)
    seconds = time.time() - t0
    launches = dict(netsim_chunk=nc.LAUNCH_COUNT, mltcp_step=ms.LAUNCH_COUNT,
                    flash_attention=fa.LAUNCH_COUNT, rg_lru=rl.LAUNCH_COUNT,
                    fallbacks=ops.FALLBACK_COUNT + ops.CHUNK_FALLBACK_COUNT)
    return out, dict(argv=list(argv), seconds=seconds, launches=launches,
                     lines=buf.getvalue().splitlines())


def phase_examples(kern, fa, rl) -> dict:
    """The four examples' ``main`` on the card, each counted alone:
    interleave_demo (the armed chunk kernel, one launch a chunk of each
    scheme, no fallback, a finite time to interleave for MLTCP),
    simulate_cluster (one launch a chunk of each scheme, finite values),
    serve_lm on recurrentgemma-2b (one flash launch per attention block
    and one RG-LRU launch per recurrent block of the prefill, decode on
    the plain path) and quickstart (its own assertion that the loss
    dropped; xLSTM launches none of the kernels); nothing else launched."""
    from repro_torch.cluster.runner import shared_cluster_plan
    from repro_torch.examples import interleave_demo, simulate_cluster

    none = dict(netsim_chunk=0, mltcp_step=0, flash_attention=0, rg_lru=0,
                fallbacks=0)
    t0 = time.time()
    out = {}
    for name, argv in EXAMPLES:
        res, row = run_example(kern, fa, rl, name, argv)
        if name == "interleave_demo":
            cfg = interleave_demo.make_plan(interleave_demo.SIM_TIME).build(
                {"scheme": "mltcp"})
            want = dict(none, netsim_chunk=2 * n_chunks_run(cfg))
            if not (math.isfinite(res["tti_s"])
                    and math.isfinite(res["tti_iters"])):
                raise AssertionError(f"interleave_demo: MLTCP did not "
                                     f"interleave: {res}")
            row.update(res, ticks=ticks_run(cfg))
        elif name == "simulate_cluster":
            cfg = shared_cluster_plan(
                simulate_cluster.JOBS,
                sim_time=simulate_cluster.SIM_TIME).build(
                    {"scheme": "mltcp"})
            want = dict(none, netsim_chunk=2 * n_chunks_run(cfg))
            values = (res.baseline_avg + res.mltcp_avg
                      + [res.avg_speedup, res.p99_speedup,
                         res.interleave_before, res.interleave_after])
            if not all(map(math.isfinite, values)):
                raise AssertionError(f"simulate_cluster: values {values}")
            row.update(avg_speedup=res.avg_speedup,
                       p99_speedup=res.p99_speedup,
                       interleave=[res.interleave_before,
                                   res.interleave_after],
                       ticks=ticks_run(cfg))
        elif name == "serve_lm":
            kinds = [blk.kind for blk in res["model"].layers]
            want = dict(none, flash_attention=kinds.count("attn")
                        + kinds.count("attn_local"),
                        rg_lru=kinds.count("rec"))
            row.update(prefill_ms=1e3 * res["prefill_s"],
                       decode_tok_per_s=res["decode_tok_per_s"],
                       generated_shape=list(res["generated"].shape))
        else:
            want = none
            row.update(steps=res["steps"], first_loss=res["first_loss"],
                       last_loss=res["last_loss"],
                       median_step_s=statistics.median(res["step_s"]),
                       first_step_s=res["step_s"][0])
        if row["launches"] != want:
            raise AssertionError(f"{name}: launches {row['launches']}, "
                                 f"expected {want}")
        out[name] = row
    out["seconds"] = time.time() - t0
    emit("examples", **out)
    return out


# ---------------------------------------------------------------------------
# the one-card dry run and roofline (launch/dryrun.py, roofline/analysis.py)
# ---------------------------------------------------------------------------

DRYRUN_CELLS_OK = "dry-run: 32 ok, 8 skipped (documented), 0 failed"
# run on the card at one row, full width and depth (bf16 serving; a train
# cell in the reference's hyper with one microbatch), weights from seed 0
DRYRUN_CARD_CELLS = (("recurrentgemma-2b", "prefill_32k"),
                     ("recurrentgemma-2b", "decode_32k"),
                     ("recurrentgemma-2b", "long_500k"),
                     ("recurrentgemma-2b", "train_4k"),
                     ("qwen3-1.7b", "prefill_32k"),
                     ("xlstm-125m", "long_500k"))
DRYRUN_WARM = 2                 # warm steps of each card cell, each held
# Memory is held in two parts, each between the count and the count plus
# what the card's caching allocator may add (`dryrun.alloc_slack`: 512 B
# rounding, and up to 1 MiB more on a block over 1 MiB): the arguments
# (memory_allocated after the cell is built, against argument_bytes and
# argument_slack_bytes) and the step's own bytes (max_memory_allocated
# less memory_allocated before the step, against temp_bytes and
# temp_upper_bytes).  A decode step replaces entries of the cache it is
# given, so each step gets a new zeroed cache, as the count's did; and on
# both sides the caller holds every argument through the step, since a
# freed argument's whole block (up to 1 MiB over its bytes) leaves the
# card's live bytes and only its bytes the count's.  On an
# H100 80GB HBM3 at 700 W the step's own bytes equal the count on the two
# prefills and the decode steps, and sit 3.06 MB (train) and 0.40 MB
# (xlstm-125m's decode) above it; the arguments 14 KB to 386 MB above.
# bf16 serving: recurrentgemma-2b at 1 x 4096 + 16, the kernel path's
# prefill against the plain path's, both bf16 (max |diff| over max |plain|;
# 0.0103 on the H100; flash alone is held to 2e-2 in bf16, 26 layers
# compound it)
BF16_SERVE_PROMPT = 4096
BF16_SERVE_NEW = 16
BF16_SERVE_REL_BOUND = 5e-2
# flash at qwen3-1.7b's prefill_32k shape, bf16, causal
QWEN_FLASH_CASE = (1, 32768, 32768, 16, 8, 128, True, 0, None, "bfloat16")
# ... held per output row (one query position and head, over the head
# dimension): |kernel - reference| / |reference|, both 2-norms, against
# SDPA's FLASH backend and the port's own chunked plain route
# (models/attention.attend, use_kernel=False) in float32 on the same bf16
# inputs.  The plain route in bf16 rounds its scores to bf16 and sits
# 2.6e-2 from both (H100 80GB HBM3, 700 W): it is recorded, not held.
# With random q, k and v a row over n keys has |out| ~ sqrt(dh / n), so
# FLASH_TOL's absolute 2e-2 is as large as the late rows themselves; the
# ratio is not (the kernel sits 4.9e-3 from SDPA on it, same card).
# Zeroing v over one of the kernel's 32-key tiles moves a row over n keys
# by about sqrt(32 / n) of itself (0.031 at n = 32768), more or less as
# the softmax weights those keys: `qwen_flash_bf16` checks that the bound
# sees that tile, zeroed midway, in the last query block's rows alone
# (0.13 at most there, same card).
QWEN_FLASH_ROW_BOUND = 1e-2
QWEN_FLASH_TILE = (16384, 32)   # (first key, keys): the kernel's BK
QWEN_FLASH_LATE_ROWS = 64       # the last query block: the kernel's BQ


def dryrun_counts() -> dict:
    """Every (architecture x shape) cell counted on the meta device (the
    kernel route; the plain route is the CPU tests' parity check), with
    its roofline terms on the H100, by cell."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun as dr
    from repro_torch.roofline import analysis

    t0 = time.time()
    records = {}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            rec = dr.run_cell(arch, shape, verbose=False, plain=False)
            if rec["status"] == "ok":
                rec = analysis.roofline_cell(arch, shape, record=rec,
                                             verbose=False)
            rec.pop("traceback", None)
            records[f"{arch}/{shape}"] = rec
    said = dr.summary(records.values())
    if said != DRYRUN_CELLS_OK:
        bad = {k: r.get("error") for k, r in records.items()
               if r["status"] == "error"}
        raise AssertionError(f"{said}, expected {DRYRUN_CELLS_OK}: {bad}")
    return dict(summary=said, seconds=time.time() - t0, cells=records)


def card_cell(fa, rl, arch: str, shape: str) -> dict:
    """One cell at one row: counted on meta, then run on the card (a cold
    step, then DRYRUN_WARM warm steps): each warm step's launches equal
    the planned ones, its CUDA-event time is at least the roofline bound,
    and its arguments and own bytes lie within what the count allows (see
    DRYRUN_WARM).  What fails is listed in the row's ``failed``."""
    import gc

    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import api
    from repro_torch.roofline.hw import H100

    cfg = get_config(arch)
    cell = dr.build_cell(cfg, shape, rows=1, microbatches=1)
    held = dr._tensors(cell.args)       # the caller keeps every argument
    meta = dr.count_cell(cell)
    del cell, held
    dtype = dr.build_dtype(cfg, shape)
    terms = {"compute": meta["flops"] / H100.peak_flops(dtype),
             "memory": meta["bytes"] / H100.hbm_bw}
    bound_s = max(terms.values())
    decode = SHAPES[shape].kind == "decode"

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cell = dr.build_cell(cfg, shape, rows=1, device=DEVICE, microbatches=1,
                         seed=0)
    torch.cuda.synchronize()
    card_args = torch.cuda.memory_allocated() - base
    out = cell.step(*cell.args)          # cold
    torch.cuda.synchronize()
    del out
    steps = []
    for _ in range(DRYRUN_WARM):
        if decode:      # a new zeroed cache, held by the step's dict alone
            model, rest = cell.args[0], cell.args[2:]
            cell = cell._replace(args=())
            gc.collect()
            cell = cell._replace(args=(model, api.init_cache(
                cfg, 1, SHAPES[shape].seq_len, dr.SERVE_DTYPE, DEVICE),
                *rest))
            del model, rest
        gc.collect()
        held = dr._tensors(cell.args)
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated() - base
        before = (fa.LAUNCH_COUNT, rl.LAUNCH_COUNT)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = cell.step(*cell.args)
        end.record()
        end.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in _step_results(out))
        del out, held
        steps.append(dict(
            ms=start.elapsed_time(end), live_before_bytes=live,
            peak_bytes=peak, temp_bytes=peak - live,
            launches=dict(flash_attention=fa.LAUNCH_COUNT - before[0],
                          rg_lru=rl.LAUNCH_COUNT - before[1]),
            finite=finite))
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    row = dict(
        arch=arch, shape=shape, rows=1, dtype=str(dtype), steps=steps,
        ms=min(s["ms"] for s in steps), planned=meta["planned_launches"],
        flops=meta["flops"], bytes=meta["bytes"],
        counted_peak_bytes=meta["peak_bytes"],
        counted_argument_bytes=meta["argument_bytes"],
        counted_argument_slack_bytes=meta["argument_slack_bytes"],
        card_argument_bytes=card_args,
        counted_temp_bytes=meta["temp_bytes"],
        counted_temp_upper_bytes=meta["temp_upper_bytes"],
        card_temp_bytes=max(s["temp_bytes"] for s in steps),
        card_peak_bytes=max(s["peak_bytes"] for s in steps),
        bound_ms=1e3 * bound_s, bound_by=("operations" if terms["compute"]
                                          >= terms["memory"] else "bytes"),
        count_s=meta["count_s"])
    row["time_over_bound"] = row["ms"] / row["bound_ms"]
    row["peak_rel_diff"] = (abs(row["card_peak_bytes"]
                                - row["counted_peak_bytes"])
                            / row["counted_peak_bytes"])
    failed = []
    for s in steps:
        if s["launches"] != meta["planned_launches"]:
            failed.append(f"launched {s['launches']}, planned "
                          f"{meta['planned_launches']}")
        if not s["finite"]:
            failed.append("non-finite results")
        if not (meta["temp_bytes"] <= s["temp_bytes"]
                <= meta["temp_upper_bytes"]):
            failed.append(f"the step's own bytes {s['temp_bytes']} outside "
                          f"[{meta['temp_bytes']}, "
                          f"{meta['temp_upper_bytes']}]")
    if row["ms"] < row["bound_ms"]:
        failed.append(f"{row['ms']} ms under the roofline bound "
                      f"{row['bound_ms']} ms: the count is wrong")
    high = meta["argument_bytes"] + meta["argument_slack_bytes"]
    if not meta["argument_bytes"] <= card_args <= high:
        failed.append(f"arguments {card_args} B outside "
                      f"[{meta['argument_bytes']}, {high}]")
    row["failed"] = [f"{arch} x {shape}: {f}" for f in failed]
    return row


def _step_results(out) -> list:
    """The floating tensors among a step's results (its state excluded)."""
    import torch

    found = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                found.append(x)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
            for y in x:
                walk(y)
    walk(out)
    return found


def bf16_serving(fa, rl) -> dict:
    """recurrentgemma-2b served in bf16 through ``launch.serve`` (the kernel
    path), its prefill then held against the plain path's, both bf16."""
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.models import api

    fa.LAUNCH_COUNT = rl.LAUNCH_COUNT = 0
    torch.cuda.reset_peak_memory_stats()
    out = serve(SERVE_ARCH, batch=1, prompt_len=BF16_SERVE_PROMPT,
                new_tokens=BF16_SERVE_NEW, preset="full", seed=0,
                device=DEVICE, dtype="bfloat16")
    torch.cuda.synchronize()
    launches = dict(flash_attention=fa.LAUNCH_COUNT, rg_lru=rl.LAUNCH_COUNT)
    cfg, model, req = out["cfg"], out["model"], out["request"]
    kinds = [blk.kind for blk in model.layers]
    want = dict(
        flash_attention=kinds.count("attn_local") + kinds.count("attn"),
        rg_lru=kinds.count("rec"))
    with torch.no_grad():
        logits_k, _ = api.prefill(cfg, model, req, out["max_len"],
                                  use_kernel=True)
        logits_p, _ = api.prefill(cfg, model, req, out["max_len"],
                                  use_kernel=False)
    if logits_k.dtype != torch.bfloat16 or not bool(
            torch.isfinite(logits_k.float()).all()):
        raise AssertionError(f"bf16 prefill: logits {logits_k.dtype}, "
                             f"finite {bool(torch.isfinite(logits_k).all())}")
    diff, rel = _rel_diff(logits_k, logits_p)
    same = bool((torch.argmax(logits_k.float(), -1)
                 == torch.argmax(logits_p.float(), -1)).all())
    res = dict(arch=SERVE_ARCH, batch=1, prompt_len=BF16_SERVE_PROMPT,
               new_tokens=BF16_SERVE_NEW, dtype="bfloat16",
               launches=launches, prefill_ms=out["prefill_s"] * 1e3,
               decode_tok_per_s=out["decode_tok_per_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               logits_max_abs_diff=diff, logits_max_rel_diff=rel,
               rel_bound=BF16_SERVE_REL_BOUND, first_token_same=same)
    del out, model, logits_k, logits_p
    torch.cuda.empty_cache()
    if launches != want:
        raise AssertionError(f"bf16 serve: launches {launches}, expected "
                             f"{want} (one prefill)")
    if rel > BF16_SERVE_REL_BOUND:
        raise AssertionError(f"bf16 kernel vs plain prefill: {rel} over "
                             f"{BF16_SERVE_REL_BOUND}")
    return res


def row_rel_err(got, want) -> "torch.Tensor":
    """Per output row ([..., D] -> [...]): the 2-norm of got - want over
    that of want, in float32."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30))


def qwen_flash_bf16(fa) -> dict:
    """The flash kernel at qwen3-1.7b's prefill_32k shape in bf16: held
    within FLASH_TOL of SDPA's FLASH backend, and row by row within
    QWEN_FLASH_ROW_BOUND of it and of the port's chunked plain route in
    float32 on the same inputs (the dense plain version would need 68
    GB); then timed beside its bound at the bf16 peak and SDPA.  The row
    check must see one KV tile of v zeroed in the last query block's
    rows: the rows over the most keys, which a tile moves least."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.models.attention import attend

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(22)
    b, t, s, h, kv, dh, causal, window, _, dtype = QWEN_FLASH_CASE
    q, k, v = flash_operands(QWEN_FLASH_CASE, gen)
    kern = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731

    def library(v=v):
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)
    got, lib = kern(), library()
    cfg = get_config("qwen3-1.7b")
    with torch.no_grad():
        plain = attend(cfg, q.float(), k.float(), v.float(), causal=causal)
        err_plain = float(row_rel_err(got, plain).max())
        err_lib_plain = float(row_rel_err(lib, plain).max())
        plain = attend(cfg, q, k, v, causal=causal)
        err_plain_bf16 = float(row_rel_err(got, plain).max())
    err_lib = float(row_rel_err(got, lib).max())
    zeroed = v.clone()
    first, n_keys = QWEN_FLASH_TILE
    zeroed[:, first:first + n_keys] = 0
    late = slice(t - QWEN_FLASH_LATE_ROWS, t)
    tile_seen = float(row_rel_err(library(zeroed)[:, late],
                                  lib[:, late]).max())
    err_abs = float((got.float() - lib.float()).abs().max())
    del got, lib, plain, zeroed
    failed = []
    if err_abs > FLASH_TOL[dtype]:
        failed.append(f"flash vs SDPA at {QWEN_FLASH_CASE}: {err_abs} over "
                      f"{FLASH_TOL[dtype]}")
    if max(err_lib, err_plain) > QWEN_FLASH_ROW_BOUND:
        failed.append(f"flash at {QWEN_FLASH_CASE}: row error {err_lib} "
                      f"(SDPA), {err_plain} (float32 plain route) over "
                      f"{QWEN_FLASH_ROW_BOUND}")
    if tile_seen <= QWEN_FLASH_ROW_BOUND:
        failed.append(f"v zeroed over keys {QWEN_FLASH_TILE} moves the last "
                      f"rows by {tile_seen} at most, within the bound "
                      f"{QWEN_FLASH_ROW_BOUND}: the check is blind to a tile")
    b_ms, b_by, flop, nbytes = flash_bound(b, t, s, h, kv, dh, causal,
                                           window, dtype)
    before = fa.LAUNCH_COUNT
    res = dict(shape=[b, t, s, h, kv, dh], causal=causal, dtype=dtype,
               ms=event_ms(kern, 5), library_ms=event_ms(library, 5),
               library="scaled_dot_product_attention (FLASH_ATTENTION "
                       "backend, enable_gqa=True, is_causal)",
               max_row_rel_err_vs_library=err_lib,
               max_row_rel_err_vs_plain_route_f32=err_plain,
               library_vs_plain_route_f32_max_row_rel_err=err_lib_plain,
               max_row_rel_err_vs_plain_route_bf16=err_plain_bf16,
               zeroed_tile=list(QWEN_FLASH_TILE),
               zeroed_tile_late_rows_max_row_rel=tile_seen,
               row_bound=QWEN_FLASH_ROW_BOUND,
               max_abs_err_vs_library=err_abs, bound_ms=b_ms, bound_by=b_by,
               flop=flop, bytes=nbytes, failed=failed)
    res["launches"] = fa.LAUNCH_COUNT - before
    res["tflop_per_s"] = flop / (res["ms"] * 1e-3) / 1e12
    del q, k, v
    torch.cuda.empty_cache()
    return res


def phase_dryrun(fa, rl) -> dict:
    """The dry run: every cell counted on meta, bf16 serving against the
    plain path, six cells on the card held against their counts, and flash
    at qwen3-1.7b's prefill_32k shape in bf16."""
    t0 = time.time()
    counts = dryrun_counts()
    served = bf16_serving(fa, rl)
    card = [card_cell(fa, rl, arch, shape)
            for arch, shape in DRYRUN_CARD_CELLS]
    failed = []
    for row in card:
        rec = counts["cells"][f"{row['arch']}/{row['shape']}"]
        row["rows_that_fit"] = rec["rows_that_fit"]
        if not rec["rows_that_fit"] >= 1:
            row["failed"].append(f"{row['arch']} x {row['shape']}: "
                                 f"rows_that_fit {rec['rows_that_fit']}")
        failed += row["failed"]
    flash = qwen_flash_bf16(fa)
    failed += flash["failed"]
    res = dict(count=dict(summary=counts["summary"],
                          seconds=counts["seconds"],
                          count_s={k: r["count_s"] for k, r in
                                   counts["cells"].items()
                                   if r["status"] == "ok"}),
               bf16_serving=served, card_cells=card, flash_bf16_32k=flash,
               seconds=time.time() - t0)
    emit("dryrun", **res)
    if failed:
        raise AssertionError("dryrun: " + "; ".join(failed))
    RESULTS["dryrun_cells"] = counts["cells"]
    return res


# The mesh phase: each device's share of three cells on the 16 x 16 mesh
# (rank 0 of a fake process group of 256, its local shards on the card;
# the fake group's collectives move nothing, so the step's values are not
# the mesh's and only times, launches and memory are read), counted on the
# same group on meta first.  Random weights from seed 0, full published
# width and depth (one device's counted peak is within the card for each:
# llama4-maverick's, the largest, 58.3 GB).
MESH_CELLS = (("qwen3-1.7b", "train_4k"), ("recurrentgemma-2b", "prefill_32k"),
              ("llama4-maverick-400b-a17b", "train_4k"))
MESH_WARM = 3                   # warm steps a cell, their median read
# (b): a real NCCL (2, 2) train step of qwen3-1.7b at full width (its
# depth cut to MESH_NCCL_LAYERS) against the one-card step of the same
# weights, float32, within MESH_NCCL_TOL of each tensor's largest |value|
MESH_NCCL_ARCH = "qwen3-1.7b"
MESH_NCCL_LAYERS = 4
MESH_NCCL_ROWS, MESH_NCCL_SEQ = 8, 512
MESH_NCCL_TOL = 1e-5
MESH_NCCL_DIR = os.path.join(ROOT, "build", "mesh_nccl")


class _KernelShapes:
    """Records each flash and RG-LRU wrapper call's local operand shapes
    while active (the wrappers stay the module's functions)."""

    def __init__(self, fa, rl):
        self.fa, self.rl = fa, rl
        self.flash, self.scan = set(), set()

    def __enter__(self):
        fa_call, rl_call = self.fa.flash_attention, self.rl.rg_lru
        self._saved = (fa_call, rl_call)

        def flash(q, k, v, *, causal=True, window=0, softcap=None):
            self.flash.add((tuple(q.shape), tuple(k.shape),
                            str(q.dtype).removeprefix("torch."), causal,
                            window, softcap))
            return fa_call(q, k, v, causal=causal, window=window,
                           softcap=softcap)

        def scan(a, b, h0=None):
            self.scan.add((tuple(a.shape), str(a.dtype).removeprefix(
                "torch."), h0 is not None))
            return rl_call(a, b, h0)

        self.fa.flash_attention, self.rl.rg_lru = flash, scan
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention, self.rl.rg_lru = self._saved


def mesh_kernel_checks(fa, rl, ref, flash_shapes, scan_shapes) -> list:
    """Each kernel at the local shapes a mesh cell gave it, against its
    plain version on the same random operands: flash within FLASH_TOL,
    RG-LRU bit for bit.  These launches are not the path's."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    checks = []
    for qs, ks, dtype, causal, window, cap in sorted(flash_shapes, key=str):
        if qs[2] == 0:
            continue
        dt = _tdtype(dtype)
        q = torch.randn(qs, generator=gen, device=DEVICE).to(dt)
        k = torch.randn(ks, generator=gen, device=DEVICE).to(dt)
        v = torch.randn(ks, generator=gen, device=DEVICE).to(dt)
        got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap).float()
        want = ref.ref_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap).float()
        tol = FLASH_TOL[dtype]
        err = float((got - want).abs().max())
        checks.append(dict(kernel="flash_attention", q=list(qs), k=list(ks),
                           dtype=dtype, causal=causal, window=window,
                           max_abs_err=err, tol=tol,
                           ok=bool(torch.allclose(got, want, atol=tol,
                                                  rtol=tol))))
        del q, k, v, got, want
    for shape, dtype, with_h0 in sorted(scan_shapes, key=str):
        dt = _tdtype(dtype)
        a = (torch.rand(shape, generator=gen, device=DEVICE) * 0.79
             + 0.2).to(dt)
        x = torch.randn(shape, generator=gen, device=DEVICE).to(dt)
        h0 = (torch.randn((shape[0], shape[2]), generator=gen,
                          device=DEVICE).to(dt) if with_h0 else None)
        got = rl.rg_lru(a, x, h0)
        want = ref.ref_rg_lru(a, x, h0)
        bits = torch.int16 if dtype == "bfloat16" else torch.int32
        checks.append(dict(kernel="rg_lru", shape=list(shape), dtype=dtype,
                           h0=with_h0, max_abs_err=float(
                               (got.float() - want.float()).abs().max()),
                           ok=bool(torch.equal(got.view(bits),
                                               want.view(bits)))))
        del a, x, h0, got, want
    torch.cuda.empty_cache()
    return checks


def mesh_cell(fa, rl, ref, arch: str, shape: str, meta, card, rules=None,
              knobs=None, count=None, warm: int = MESH_WARM,
              checked=None) -> dict:
    """One cell's per-device share: counted on ``meta`` (the fake group's
    meta mesh; ``count``, where given, is that count), then built on
    ``card`` (the same group's CUDA mesh, rank 0's shards drawn from seed
    0) and run cold, then ``warm`` times, each warm step timed with CUDA
    events with the launch counts set to 0 before it and read after.  By
    the reference's production rules and knobs, or by ``rules`` with the
    hillclimb's ``knobs`` (`roofline.hillclimb.set_knobs`'s arguments).
    Fails (``failed``) where a warm step's launches differ from the
    planned ones, its time is under the per-device bound, or a kernel
    disagrees with its plain version at the local shapes the cell gave it
    (``checked``: the checks of shapes held already, by shape, reused and
    added to)."""
    import gc

    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshes
    from repro_torch.roofline import hillclimb
    from repro_torch.roofline.hw import H100

    cfg = get_config(arch)
    kind = SHAPES[shape].kind
    if rules is None:
        rules = dr.default_rules_for(arch, kind, meta)
        knobs_set = dr.production_knobs(arch, kind)
    else:
        knobs_set = hillclimb.set_knobs(**(knobs or {}))
    with knobs_set:
        if count is None:
            count = dr._count(cfg, shape, mesh=meta, rules=rules)
        dtype = dr.build_dtype(cfg, shape)
        terms = {"compute": count["flops"] / H100.peak_flops(dtype),
                 "memory": count["bytes"] / H100.hbm_bw}
        bound_ms = 1e3 * max(terms.values())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        cell = dr.build_cell(cfg, shape, device=DEVICE, mesh=card,
                             rules=rules, microbatches=1, seed=0)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        card_args = torch.cuda.memory_allocated() - base
        with _KernelShapes(fa, rl) as seen, dr.on_mesh(card):
            t0 = time.time()
            out = cell.step(*cell.args)      # cold
            torch.cuda.synchronize()
            cold_s = time.time() - t0
        del out
        steps = []
        for _ in range(warm):
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            fa.LAUNCH_COUNT = rl.LAUNCH_COUNT = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with dr.on_mesh(card):
                start.record()
                out = cell.step(*cell.args)
                end.record()
            end.synchronize()
            launches = dict(flash_attention=fa.LAUNCH_COUNT,
                            rg_lru=rl.LAUNCH_COUNT)
            peak = torch.cuda.max_memory_allocated() - base
            del out
            steps.append(dict(ms=start.elapsed_time(end), peak_bytes=peak,
                              launches=launches))
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    checked = {} if checked is None else checked
    for key in sorted(seen.flash, key=str):
        if key not in checked:
            checked[key] = mesh_kernel_checks(fa, rl, ref, {key}, ())
    for key in sorted(seen.scan, key=str):
        if key not in checked:
            checked[key] = mesh_kernel_checks(fa, rl, ref, (), {key})
    checks = [c for key in sorted(seen.flash | seen.scan, key=str)
              for c in checked[key]]
    colls = count["collectives"]
    ways = math.prod(meshes.axis_sizes(meta)[a] for a in rules.data_axes)
    rows = SHAPES[shape].global_batch
    row = dict(
        arch=arch, shape=shape, mesh="16x16", rank=0,
        layers=cfg.n_layers, dtype=str(dtype).removeprefix("torch."),
        rows_per_device=rows // ways if rows % ways == 0 else rows,
        ms=statistics.median(s["ms"] for s in steps), steps=steps,
        cold_s=cold_s, build_s=build_s,
        bound_ms=bound_ms, bound_by=("operations" if terms["compute"]
                                     >= terms["memory"] else "bytes"),
        flops_per_device=count["flops"],
        bytes_accessed_per_device=count["bytes"],
        t_collective_s=colls["total_bytes"] / H100.ici_link_bw,
        collectives=colls,
        counted_peak_bytes=count["peak_bytes"],
        counted_argument_bytes=count["argument_bytes"],
        card_argument_bytes=card_args,
        card_peak_bytes=max(s["peak_bytes"] for s in steps),
        planned=count["planned_launches"],
        flash_local_shapes=sorted([list(x[0]), list(x[1])]
                                  for x in seen.flash),
        rg_lru_local_shapes=sorted(list(x[0]) for x in seen.scan),
        kernel_checks=checks, count_s=count["count_s"])
    row["time_over_bound"] = row["ms"] / row["bound_ms"]
    row["peak_over_count"] = row["card_peak_bytes"] / row["counted_peak_bytes"]
    failed = []
    for s in steps:
        if s["launches"] != count["planned_launches"]:
            failed.append(f"launched {s['launches']}, planned "
                          f"{count['planned_launches']}")
    if row["ms"] < row["bound_ms"]:
        failed.append(f"{row['ms']} ms under the per-device bound "
                      f"{row['bound_ms']} ms")
    failed += [f"{c['kernel']} at {c.get('q', c.get('shape'))} disagrees "
               f"with its plain version ({c['max_abs_err']})"
               for c in checks if not c["ok"]]
    if kind != "decode" and not count["planned_launches"]["flash_attention"]:
        failed.append("no flash launch planned")
    row["failed"] = [f"{arch} x {shape}: {f}" for f in failed]
    return row


def _nccl_worker(rank: int, world: int, port: int, out_dir: str,
                 device: str, shape: tuple) -> None:
    """One rank of the (b) run: the one-card step of MESH_NCCL_ARCH (full
    width, ``shape`` = (layers, rows, sequence), float32, seed 0) on its
    card, then the same weights placed on a (2, 2) mesh and the same step
    sharded, under the collective counter; rank 0 writes both to
    ``out_dir``.  NCCL on cards (``device`` "cuda"), gloo on the CPU."""
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshes
    from repro_torch.roofline.collectives import CollectiveCounter
    from repro_torch.train import TrainHyper
    from repro_torch.train.train_step import loss_fn

    layers, rows, seq = shape
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = dataclasses.replace(get_config(MESH_NCCL_ARCH),
                                  n_layers=layers)
        hyper = TrainHyper(param_dtype="float32", use_kernel=True)
        dev = torch.device("cuda", rank) if on_card else torch.device("cpu")

        def grads_of(model, batch):
            params = dict(model.named_parameters())
            loss, _ = loss_fn(cfg, model, batch, hyper)
            grads = torch.autograd.grad(loss, list(params.values()))
            return loss, dict(zip(params, grads))

        def full(t):
            t = t.detach()
            return (t.full_tensor() if isinstance(t, DTensor) else t
                    ).float().cpu()

        cell = dr.build_cell(cfg, "train_4k", rows=rows, device=dev,
                             seq_len=seq, microbatches=1, seed=0)
        state, batch = cell.args
        state.model.float()     # the cell's hyper is bf16
        loss1, grads1 = grads_of(state.model, batch)
        one = dict(loss=full(loss1), grads={n: full(g)
                                            for n, g in grads1.items()})
        del loss1, grads1
        mesh = meshes.make_debug_mesh(2, 2, device)
        placed = dr.shard_cell(cfg, "train_4k", cell, mesh, None, dev)
        with CollectiveCounter() as counter, dr.on_mesh(mesh):
            loss2, grads2 = grads_of(placed.args[0].model, placed.args[1])
            if on_card:
                torch.cuda.synchronize()
        two = dict(loss=full(loss2), grads={n: full(g)
                                            for n, g in grads2.items()})
        if rank == 0:
            torch.save(dict(one=one, two=two, collectives=counter.result()),
                       os.path.join(out_dir, "rank0.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_nccl() -> dict:
    """(b): where the machine has four cards, a real NCCL train step on
    `make_debug_mesh(2, 2)` (four processes, one a card) against the
    one-card step of the same weights, and NCCL's collective bytes (the
    counter on rank 0) against the count of the same step on a fake
    group of four on this card: they must be equal."""
    import dataclasses
    import shutil

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshes
    from repro_torch.roofline.collectives import CollectiveCounter
    from repro_torch.train import TrainHyper
    from repro_torch.train.train_step import loss_fn

    n = torch.cuda.device_count()
    if n < 4:
        print(f"mesh_nccl: not run, {n} card(s)", flush=True)
        return dict(run=False, cards=n)
    shutil.rmtree(MESH_NCCL_DIR, ignore_errors=True)
    os.makedirs(MESH_NCCL_DIR)
    t0 = time.time()
    shape = (MESH_NCCL_LAYERS, MESH_NCCL_ROWS, MESH_NCCL_SEQ)
    mp.start_processes(_nccl_worker, args=(4, _free_port(), MESH_NCCL_DIR,
                                           DEVICE, shape),
                       nprocs=4, join=True, start_method="spawn")
    got = torch.load(os.path.join(MESH_NCCL_DIR, "rank0.pt"),
                     weights_only=False)
    # the same step counted on a fake group of four, on this card
    cfg = dataclasses.replace(get_config(MESH_NCCL_ARCH),
                              n_layers=MESH_NCCL_LAYERS)
    hyper = TrainHyper(param_dtype="float32", use_kernel=True)
    fake = meshes.make_debug_mesh(2, 2, DEVICE)
    cell = dr.build_cell(cfg, "train_4k", rows=MESH_NCCL_ROWS, device=DEVICE,
                         seq_len=MESH_NCCL_SEQ, microbatches=1, seed=0,
                         mesh=fake)
    state, batch = cell.args
    state.model.float()
    params = dict(state.model.named_parameters())
    with CollectiveCounter() as counter, dr.on_mesh(fake):
        loss, _ = loss_fn(cfg, state.model, batch, hyper)
        torch.autograd.grad(loss, list(params.values()))
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    del cell, state, batch, params, loss
    counted = counter.result()

    def rel(a, b):
        scale = float(b.abs().max()) or 1.0
        return float((a - b).abs().max()) / scale

    one, two = got["one"], got["two"]
    gaps = {name: rel(two["grads"][name], g)
            for name, g in one["grads"].items()}
    row = dict(run=True, cards=n, arch=MESH_NCCL_ARCH,
               layers=MESH_NCCL_LAYERS, rows=MESH_NCCL_ROWS,
               seq=MESH_NCCL_SEQ, tol=MESH_NCCL_TOL,
               loss_one_card=float(one["loss"]),
               loss_mesh=float(two["loss"]),
               loss_rel_gap=rel(two["loss"], one["loss"]),
               worst_grad=max(gaps, key=gaps.get),
               worst_grad_rel_gap=max(gaps.values()),
               nccl_collectives=got["collectives"],
               fake_collectives=counted, seconds=time.time() - t0)
    failed = []
    if row["loss_rel_gap"] > MESH_NCCL_TOL:
        failed.append(f"loss {row['loss_rel_gap']} over {MESH_NCCL_TOL}")
    if row["worst_grad_rel_gap"] > MESH_NCCL_TOL:
        failed.append(f"gradient {row['worst_grad']} "
                      f"{row['worst_grad_rel_gap']} over {MESH_NCCL_TOL}")
    if got["collectives"]["bytes_by_kind"] != counted["bytes_by_kind"]:
        failed.append(f"NCCL's collective bytes "
                      f"{got['collectives']['bytes_by_kind']} != the fake "
                      f"group's {counted['bytes_by_kind']}")
    row["failed"] = [f"mesh_nccl: {f}" for f in failed]
    return row


def phase_mesh(fa, rl, ref) -> dict:
    """The device mesh: (a) each device's share of MESH_CELLS on the card
    (`mesh_cell`), (b) where there are four cards, a real NCCL (2, 2) step
    (`mesh_nccl`).  The phase emits its line before it raises."""
    import torch

    from repro_torch.launch import mesh as meshes

    t0 = time.time()
    meta = meshes.make_production_mesh(False, "meta")
    card = meshes.make_production_mesh(False, DEVICE)
    cells = [mesh_cell(fa, rl, ref, arch, shape, meta, card)
             for arch, shape in MESH_CELLS]
    failed = [f for row in cells for f in row["failed"]]
    nccl = mesh_nccl()
    failed += nccl.get("failed", [])
    res = dict(note="fake process group of 256, rank 0: the collectives "
                    "move no data, so the step's values are not the "
                    "mesh's; only times, launches and memory are read",
               cells=cells, nccl=nccl, device=torch.cuda.get_device_name(0),
               seconds=time.time() - t0)
    emit("mesh", **res)
    for row in cells:
        print(f"mesh: {row['arch']} x {row['shape']} ({row['layers']} "
              f"layers, rank 0 of 16x16): {row['ms']:.1f} ms a step "
              f"(bound {row['bound_ms']:.1f} ms, {row['bound_by']}), "
              f"t_collective {row['t_collective_s']:.3f} s, peak "
              f"{row['card_peak_bytes'] / 1e9:.2f} GB (counted "
              f"{row['counted_peak_bytes'] / 1e9:.2f}), launches "
              f"{row['steps'][0]['launches']} (planned {row['planned']})",
              flush=True)
    if failed:
        raise AssertionError("mesh: " + "; ".join(failed))
    return res


HILLCLIMB_WARM = 1              # warm steps an experiment, after its cold


def phase_hillclimb(fa, rl, ref) -> dict:
    """The hillclimb's experiments (`roofline.hillclimb.EXPERIMENTS`) on
    the kernel route: each counted on the meta 16 x 16 mesh by its rules
    and knobs; where its count equals an earlier experiment's (FLOPs,
    bytes, collective bytes) it is not run again, where its counted peak
    does not fit the card it is not run; every other one runs as rank 0's
    share on the card (`mesh_cell`: launches as planned, time at or above
    the per-device bound, peak beside the count, the kernels at their
    local shapes).  Each line sets the counted bound (the per-device
    compute and memory terms; the roofline's, with the collective term,
    beside it) and the card's time, each as a ratio to the baseline's.
    The phase emits its line before it raises."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshes
    from repro_torch.roofline import hillclimb
    from repro_torch.roofline.hw import H100

    t0 = time.time()
    meta = meshes.make_production_mesh(False, "meta")
    card = meshes.make_production_mesh(False, DEVICE)
    rows, failed, by_count, checked = {}, [], {}, {}
    for exp in hillclimb.EXPERIMENTS:
        cfg = get_config(exp.arch)
        rules = exp.rules or dr.reference_rules(meta)
        t1 = time.time()
        with hillclimb.set_knobs(**exp.knobs):
            count = dr._count(cfg, exp.shape, mesh=meta, rules=rules)
        dtype = dr.build_dtype(cfg, exp.shape)
        terms = {"compute": count["flops"] / H100.peak_flops(dtype),
                 "memory": count["bytes"] / H100.hbm_bw}
        coll_s = count["collectives"]["total_bytes"] / H100.ici_link_bw
        key = (count["flops"], count["bytes"],
               count["collectives"]["total_bytes"])
        row = dict(name=exp.name, arch=exp.arch, shape=exp.shape,
                   baseline=exp.baseline, knobs=dict(exp.knobs),
                   rules=dr.rules_record(rules, "given" if exp.rules
                                         else "reference"),
                   bound_ms=1e3 * max(terms.values()),
                   bound_by=("operations" if terms["compute"]
                             >= terms["memory"] else "bytes"),
                   roofline_bound_ms=1e3 * max(coll_s, *terms.values()),
                   t_collective_s=coll_s,
                   flops_per_device=count["flops"],
                   bytes_accessed_per_device=count["bytes"],
                   coll_bytes_per_device=count["collectives"]["total_bytes"],
                   counted_peak_bytes=count["peak_bytes"],
                   planned=count["planned_launches"],
                   count_s=time.time() - t1, ran=False)
        if key in by_count:
            row["same_count_as"] = by_count[key]
        elif count["peak_bytes"] > H100.hbm_bytes:
            row["fits"] = False
        else:
            by_count[key] = exp.name
            try:
                cell = mesh_cell(fa, rl, ref, exp.arch, exp.shape, meta,
                                 card, rules=rules, knobs=exp.knobs,
                                 count=count, warm=HILLCLIMB_WARM,
                                 checked=checked)
            except Exception as e:  # noqa: BLE001 — emitted, then raised
                row["error"] = f"{type(e).__name__}: {e}"[:2000]
                failed.append(f"{exp.name}: {row['error']}")
                rows[exp.name] = row
                torch.cuda.empty_cache()
                continue
            failed += [f"{exp.name}: {f}" for f in cell["failed"]]
            row.update(ran=True, fits=True, ms=cell["ms"],
                       steps=cell["steps"], cold_s=cell["cold_s"],
                       build_s=cell["build_s"],
                       card_peak_bytes=cell["card_peak_bytes"],
                       peak_over_count=cell["peak_over_count"],
                       time_over_bound=cell["time_over_bound"],
                       flash_local_shapes=cell["flash_local_shapes"],
                       kernel_checks=cell["kernel_checks"])
        rows[exp.name] = row

    def measured(row):
        return rows[row.get("same_count_as", row["name"])]

    for row in rows.values():
        base = rows.get(row["baseline"])
        if base is None:
            continue
        row["bound_ratio"] = row["bound_ms"] / base["bound_ms"]
        row["roofline_ratio"] = (row["roofline_bound_ms"]
                                 / base["roofline_bound_ms"])
        got, want = measured(row), measured(base)
        if "ms" in got and "ms" in want:
            row["card_ratio"] = got["ms"] / want["ms"]
    res = dict(note="kernel route, rank 0 of a fake 16x16 group: the "
                    "collectives move no data, so only the compute and "
                    "memory terms bound a step; the ratios are against "
                    "each experiment's baseline",
               experiments=list(rows.values()),
               device=torch.cuda.get_device_name(0),
               seconds=time.time() - t0)
    emit("hillclimb", **res)
    for row in rows.values():
        head = (f"hillclimb: {row['name']} ({row['arch']} x {row['shape']}"
                f"): bound {row['bound_ms']:.2f} ms ({row['bound_by']}), "
                f"roofline {row['roofline_bound_ms']:.2f} ms")
        if "bound_ratio" in row:
            head += (f", x{row['bound_ratio']:.3f} / "
                     f"x{row['roofline_ratio']:.3f} of {row['baseline']}'s")
        if "same_count_as" in row:
            tail = f"; same count as {row['same_count_as']}, not run again"
        elif "error" in row:
            tail = f"; FAILED on the card: {row['error'][:300]}"
        elif not row["ran"]:
            tail = (f"; counted peak {row['counted_peak_bytes'] / 1e9:.2f} "
                    f"GB does not fit the card, not run")
        else:
            tail = (f"; card {row['ms']:.2f} ms ({row['time_over_bound']:.2f}"
                    f"x the bound), peak {row['card_peak_bytes'] / 1e9:.2f} "
                    f"GB (counted {row['counted_peak_bytes'] / 1e9:.2f}), "
                    f"launches {row['steps'][0]['launches']}")
        if "card_ratio" in row:
            tail += f", card x{row['card_ratio']:.3f} of the baseline's"
        print(head + tail, flush=True)
    if failed:
        raise AssertionError("hillclimb: " + "; ".join(failed))
    return res


def armed_attributes(nc, netsim, core, workload) -> dict:
    """Registers, spills and static shared memory of each armed
    instantiation (one per algorithm and ARMED; the CC selections are its
    launch dims), raising if one spills, and the dynamic shared memory of
    the armed plans' points (the fig 5 and churn widths)."""
    import dataclasses

    from repro_torch.analysis import plans as suites

    out = {f"armed{armed}_algo{algo}": nc.kernel_attributes(algo, 1, True,
                                                            False, armed)
           for armed in (nc.ARM_TEL, nc.ARM_FAULTS, nc.ARM_TEL | nc.ARM_FAULTS)
           for algo in (0, 1, 2)}
    spilling = {k: x["local_bytes"] for k, x in out.items()
                if x["local_bytes"]}
    if spilling:
        raise AssertionError(f"armed chunk kernels spill: {spilling}")
    fig5 = dataclasses.replace(
        fig7_cfg(core, netsim, workload, "reno", 1, FIG5_SIM_TIME),
        telemetry=suites.fig5_spec(FIG5_SIM_TIME))
    churn_cfg = suites.churn_plan(None, CHURN_SEEDS).build(
        dict(algo="reno", variant="WI", schedule="gauntlet", seed=1))
    return dict(instantiations=out,
                registers_range=[min(x["registers"] for x in out.values()),
                                 max(x["registers"] for x in out.values())],
                spilling=spilling,
                smem_bytes={"fig5": nc.smem_bytes(**nc.shape_of(fig5)),
                            "churn": nc.smem_bytes(**nc.shape_of(churn_cfg))})


def kernel_table(kern: dict, main: dict, states: dict, chunks: dict,
                 timing: dict, prof: dict, plans: dict, figures: dict,
                 lm: dict, served: dict, armed: dict, tel: dict, flt: dict,
                 trained: dict, families: dict, clustered: dict,
                 dry: dict, armed_plans: dict, examples: dict,
                 graphed: dict, meshed: dict, climbed: dict) -> list:
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
        # the per-tick path replayed as a CUDA graph of a chunk, against
        # its eager loop, at fig7-reno and at kernel_sweep's group
        "graphed": {name: {k: t[k] for k in (
            "k", "ticks_per_chunk", "capture_s", "instantiate_s",
            "graph_nodes", "recorded", "replay_us_per_tick",
            "graphed_us_per_tick", "eager_us_per_tick")}
            for name, t in graphed["timing"].items()},
        "graphed_cases_bitwise": sorted(graphed["cases"]),
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
        # the figures phase's plans, each counted on its own
        "figure_plan_launches": {name: row["launches"] for name, row in
                                 figures["summary"].items()},
        # the armed kernel (telemetry and faults): its plans' launches (fig
        # 17 and fig 13 armed with the fig 5 spec too), its instantiations,
        # and fig7-reno armed against unarmed
        "armed_plan_launches": {
            "fig5": tel["launches"]["netsim_chunk"],
            "churn": flt["launches"]["netsim_chunk"],
            **{name: armed_plans[name]["armed"]["launches"]["netsim_chunk"]
               for name in ARMED_PLANS}},
        # the examples that simulate (interleave_demo armed), each alone
        "example_launches": {
            name: examples[name]["launches"]["netsim_chunk"]
            for name in ("interleave_demo", "simulate_cluster")},
        # the shared-cluster driver's run (default and MLTCP, 4 s each)
        "cluster_launches": clustered["launches"]["netsim_chunk"],
        "moe_cluster_launches":
            clustered["moe_mix"]["launches"]["netsim_chunk"],
        "armed": armed,
        "armed_us_per_tick": tel["fig7_reno"]["armed_us_per_tick"],
        "unarmed_us_per_tick": tel["fig7_reno"]["unarmed_us_per_tick"],
        "max_abs_err": max([timing["max_abs_err"],
                            figures["f1_equals_linear"]["max_abs_err"]]
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
        "serve_lm_example_launches":
            examples["serve_lm"]["launches"]["flash_attention"],
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
        # qwen3-1.7b's prefill_32k shape in bf16, beside SDPA's FLASH
        # backend; and the dry run's card cells, launches as planned
        "bf16_32k": dry["flash_bf16_32k"],
        "dryrun_cell_launches": {f"{r['arch']}/{r['shape']}":
                                 r["steps"][0]["launches"]["flash_attention"]
                                 for r in dry["card_cells"]},
        # the mesh cells: rank 0's local heads of the 16x16 mesh, launches
        # of a warm step (as planned) and the local shapes
        "mesh_cell_launches": {f"{r['arch']}/{r['shape']}":
                               r["steps"][0]["launches"]["flash_attention"]
                               for r in meshed["cells"]},
        "mesh_local_shapes": {f"{r['arch']}/{r['shape']}":
                              r["flash_local_shapes"]
                              for r in meshed["cells"]},
        # the hillclimb's experiments run on the card (kernel route, rank
        # 0 of 16x16): launches of a warm step, as planned
        "hillclimb_cell_launches": {
            r["name"]: r["steps"][0]["launches"]["flash_attention"]
            for r in climbed["experiments"] if r["ran"]},
        "backward": trained["grad_checks"]["flash"],
        "shape": lm["flash"]["shape"],
    }, {
        "name": "rg_lru",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
        "replaces": RGLRU_REPLACES,
        "launches": served["launches"]["rg_lru"],
        "serve_lm_example_launches":
            examples["serve_lm"]["launches"]["rg_lru"],
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
        "dryrun_cell_launches": {f"{r['arch']}/{r['shape']}":
                                 r["steps"][0]["launches"]["rg_lru"]
                                 for r in dry["card_cells"]},
        "mesh_cell_launches": {f"{r['arch']}/{r['shape']}":
                               r["steps"][0]["launches"]["rg_lru"]
                               for r in meshed["cells"]},
        "mesh_local_shapes": {f"{r['arch']}/{r['shape']}":
                              r["rg_lru_local_shapes"]
                              for r in meshed["cells"]},
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
ONLY = ("dryrun", "mesh", "hillclimb", "suites", "per_tick_graph", "plans",
        "figures")


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
    ap.add_argument("--only", nargs="+", choices=ONLY,
                    help="build the kernels these phases run (dryrun, "
                         "mesh, hillclimb: the LM kernels; the others: the "
                         "simulator's) and "
                         "run only these phases, in this order")
    args = ap.parse_args(argv)
    probe = args.probe
    if args.probe_flash is not None:
        probe = ["flash_attention", *args.probe_flash]
    if probe and probe[0] not in PROBES:
        ap.error(f"--probe takes one of {', '.join(PROBES)}, not {probe[0]}")

    # the profiler's CUPTI teardown after each session (see `traced`)
    os.environ["TEARDOWN_CUPTI"] = "1"
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
    from repro_torch.netsim import tick_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    sim_kernels = dict(ms=ms, nc=nc, ops=ops, tg=tick_graph)
    if probe:
        if probe[0] == "flash_attention":
            probe_flash(fa, ref, probe[1:])
        else:
            probe_rg_lru(rl, ref, probe[1:])
        write_results(args.out, t_start)
        return 0
    if args.only:
        sim = dict(suites=phase_suites, per_tick_graph=phase_per_tick_graph,
                   plans=phase_plans, figures=phase_figures)
        phase_device(([ms.LIBRARY, nc.LIBRARY]
                      if set(args.only) & set(sim) else [])
                     + ([fa.LIBRARY, rl.LIBRARY]
                        if {"dryrun", "mesh", "hillclimb"} & set(args.only)
                        else []))
        for name in args.only:
            if name == "dryrun":
                phase_dryrun(fa, rl)
            elif name == "mesh":
                phase_mesh(fa, rl, ref)
            elif name == "hillclimb":
                phase_hillclimb(fa, rl, ref)
            else:
                sim[name](sim_kernels, core, netsim, workload)
        write_results(args.out, t_start)
        return 0
    dev = phase_device([ms.LIBRARY, nc.LIBRARY, fa.LIBRARY, rl.LIBRARY])
    kern = phase_kernel(ms, core)
    chunks = phase_chunk_vs_per_tick(sim_kernels, core, netsim, workload)
    graphed = phase_per_tick_graph(sim_kernels, core, netsim, workload)
    main_path = phase_main_path(sim_kernels, core, netsim, workload)
    phase_small_agreement(core, netsim)
    states = phase_engine_states(sim_kernels, core, netsim, workload)
    timing = phase_chunk_timing(sim_kernels, core, netsim, workload)
    prof = phase_profile(sim_kernels, core, netsim, workload)
    plans = phase_plans(sim_kernels, core, netsim, workload)
    figures = phase_figures(sim_kernels, core, netsim, workload)
    phase_suites(sim_kernels, core, netsim, workload)
    tel = phase_telemetry(sim_kernels, core, netsim, workload)
    flt = phase_faults(sim_kernels, core, netsim, workload)
    armed_plans = phase_armed_plans(sim_kernels, netsim)
    phase_analysis(sim_kernels)
    armed = armed_attributes(nc, netsim, core, workload)
    lm = phase_lm_kernels(fa, rl, ref)
    served = phase_serve(fa, rl, sim_kernels)
    trained = phase_train(fa, rl, ref, sim_kernels)
    families = phase_serve_families(fa, rl, sim_kernels)
    clustered = phase_cluster(sim_kernels)
    examples = phase_examples(sim_kernels, fa, rl)
    dry = phase_dryrun(fa, rl)
    meshed = phase_mesh(fa, rl, ref)
    climbed = phase_hillclimb(fa, rl, ref)
    table = kernel_table(kern, main_path, states, chunks, timing, prof,
                         plans, figures, lm, served, armed, tel, flt,
                         trained, families, clustered, dry, armed_plans,
                         examples, graphed, meshed, climbed)
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
