#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--out results.json]

It builds the fused CC-tick kernel from ``src/repro_torch/kernels/csrc``
(nvcc, sm_90a, into ``build/kernels/``), holds it bit for bit against its
plain PyTorch version for every specialization, drives the simulator's
main path at full width (the paper's Fig. 7-9 convergence setup: two GPT-2
jobs on a 50 Gbps dumbbell, Reno OFF and WI, a two-seed sweep each, 1 s
of simulated time),
checks the figure metrics, and feeds the kernel states taken from CUBIC
and DCQCN runs of the engine.  Each phase prints one JSON line; any
failure raises and the exit code is non-zero.  The last lines are the
kernel table, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Nothing here imports JAX or the
reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
DT = 2e-5
RTT = 100e-6
WORK_SCALE = 0.25                  # benchmarks/common.py (not REPRO_FULL)
# Depth of the main path: the suite's REPRO_SMOKE depth is 1.5 s, cut to
# 1.0 s (50,000 ticks) because the tick is host-bound and the card's host
# ran it at 1.8 ms and at 3.4 ms per tick on two calls (PERF.md); widths,
# jobs and protocol settings are the suite's.
MAIN_SIM_TIME = 1.0
SPEC_SIM_TIME = 0.15
AGREE_SIM_TIME = 0.06
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

def phase_device(ms) -> dict:
    import torch

    t0 = time.time()
    procs = [ms.start_build()]          # one nvcc per kernel source
    for proc in procs:
        ms.finish_build(proc)
    build_s = time.time() - t0
    regs = sorted({line.split("Used")[1].split(",")[0].strip()
                   for line in ms.BUILD_LOG.splitlines() if "Used" in line})
    info = dict(name=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), nvidia_smi=nvidia_smi(),
                torch=torch.__version__, cuda=torch.version.cuda,
                build_s=round(build_s, 3), built=bool(procs[0]),
                ptxas_registers=regs)
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
             sim_time: float):
    """benchmarks/common.build_cfg for two GPT-2 jobs on dumbbell(2, 2)."""
    slope, intercept = PARAMS[algo]
    proto = core.MLTCPConfig(
        cc=core.CCParams(algo=ALGO_ID[algo], variant=variant, tick_dt=DT,
                         rtt=RTT),
        slope=slope, intercept=intercept)
    profiles = [workload.profile_for("gpt2").scaled(WORK_SCALE)
                for _ in range(2)]
    return netsim.SimConfig(
        topo=netsim.dumbbell(2, sockets_per_job=2),
        jobs=workload.jobspec_from_profiles(profiles), protocol=proto,
        sim_time=sim_time, dt=DT, seed=SEEDS[0], **RED_BY_ALGO[algo])


def ticks_run(cfg) -> int:
    per_chunk = max(1, cfg.n_ticks // cfg.n_chunks)
    return (cfg.n_ticks // per_chunk) * per_chunk


def run_counted(ms, ops, netsim, cfg):
    """One sweep with the launch and fallback counts set to 0 just before
    and read just after; returns (raw, seconds, launches, fallbacks)."""
    import torch

    sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
    torch.cuda.synchronize()
    ms.LAUNCH_COUNT = 0
    ops.FALLBACK_COUNT = 0
    t0 = time.time()
    raw = netsim.simulate_sweep(cfg, sweep, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    return raw, seconds, ms.LAUNCH_COUNT, ops.FALLBACK_COUNT


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


def phase_main_path(ms, ops, core, netsim, workload) -> dict:
    import numpy as np

    runs = {}
    launches = 0
    for name, variant in (("OFF", 0), ("WI", 1)):
        cfg = fig7_cfg(core, netsim, workload, "reno", variant, MAIN_SIM_TIME)
        raw, seconds, n_launch, n_fallback = run_counted(ms, ops, netsim, cfg)
        ticks = ticks_run(cfg)
        if n_launch != ticks:
            raise AssertionError(f"{name}: {n_launch} kernel launches for "
                                 f"{ticks} ticks")
        if n_fallback != 0:
            raise AssertionError(f"{name}: {n_fallback} fallbacks")
        launches += n_launch
        res = check_finite(netsim, cfg, raw)
        runs[name] = dict(
            results=res, ticks=ticks, seconds=seconds, launches=n_launch,
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
        sim_time=MAIN_SIM_TIME, launches=launches, fallbacks=0,
        **{f"{v}_{k}": runs[v][k] for v in ("OFF", "WI")
           for k in ("ticks", "seconds", "us_per_tick", "interleave",
                     "iter_counts", "drops_per_s", "launches")},
        avg_speedup=sp["avg_speedup"], p99_speedup=sp["p99_speedup"],
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


def phase_engine_states(ms, ops, core, netsim, workload) -> dict:
    """CUBIC WI and DCQCN WI from the engine; their final protocol state and
    the feedback in the ring slot the next tick reads go through the kernel
    and the plain version."""
    import torch

    from repro_torch.core import iteration
    from repro_torch.netsim import engine

    out = {}
    for algo in ("cubic", "dcqcn"):
        cfg = fig7_cfg(core, netsim, workload, algo, 1, SPEC_SIM_TIME)
        raw, seconds, n_launch, n_fallback = run_counted(ms, ops, netsim, cfg)
        if n_launch != ticks_run(cfg) or n_fallback != 0:
            raise AssertionError(f"{algo}: {n_launch} launches, "
                                 f"{n_fallback} fallbacks")
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
        now = st.tick.to(torch.float32) * cfg.dt
        args = (ms.static_params(cfg.protocol.cc, True), wl.dyn.stacked(),
                arrays, now, None)
        err = compare_outputs(ms, ms.mltcp_tick(*args),
                              ms.mltcp_tick_reference(*args))
        out[algo] = dict(ticks=ticks_run(cfg), launches=n_launch,
                         us_per_tick=1e6 * seconds / ticks_run(cfg),
                         bitwise=True, max_abs_err=err)
    emit("engine_states", **out)
    return out


def phase_profile(core, netsim, workload) -> dict:
    """A profiler window over the main path's WI sweep: the card's busy
    time per tick, its share of the (profiled) wall time, the device-side
    launches per tick and the kernel's own device time per launch.  The
    profiler adds host cost, so the busy share is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ticks = 300
    cfg = fig7_cfg(core, netsim, workload, "reno", 1, ticks * DT)
    sweep = netsim.make_sweep(cfg, device=DEVICE, seed=list(SEEDS))
    netsim.simulate_sweep(cfg, sweep, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        netsim.simulate_sweep(cfg, sweep, device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.time() - t0

    rows = device_rows(prof)
    busy_us = sum(_device_us(e) for e in rows)
    kern = [e for e in rows if "mltcp_step_kernel" in e.key]
    n_kern = sum(e.count for e in kern)
    top = sorted(rows, key=_device_us, reverse=True)[:8]
    out = dict(
        ticks=ticks, wall_s=wall_s, device_busy_us=busy_us,
        busy_share=busy_us / (wall_s * 1e6),
        device_us_per_tick=busy_us / ticks,
        device_launches_per_tick=sum(e.count for e in rows) / ticks,
        kernel_launches=n_kern,
        kernel_device_us_per_launch=(sum(_device_us(e) for e in kern)
                                     / n_kern if n_kern else None),
        top=[dict(name=e.key[:70], count=e.count, device_us=_device_us(e))
             for e in top])
    emit("profile", **out)
    return out


def kernel_table(kern: dict, main: dict, states: dict) -> list:
    main_row = next(r for r in kern["main_shape"] if r["algo"] == 0)
    errs = [kern["max_abs_err"]] + [r["max_abs_err"] for r in
                                    kern["main_shape"] + kern["large"]]
    errs += [s["max_abs_err"] for s in states.values()]
    return [{
        "name": "mltcp_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mltcp_step.cu",
        "replaces": REPLACES,
        "launches": main["launches"],
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
    }]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core, netsim, workload
    from repro_torch.kernels import mltcp_step as ms
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    dev = phase_device(ms)
    kern = phase_kernel(ms, core)
    main_path = phase_main_path(ms, ops, core, netsim, workload)
    phase_small_agreement(core, netsim)
    states = phase_engine_states(ms, ops, core, netsim, workload)
    phase_profile(core, netsim, workload)
    table = kernel_table(kern, main_path, states)
    RESULTS["kernels"] = table
    RESULTS["seconds"] = time.time() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    print(json.dumps({"kernels": table}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
