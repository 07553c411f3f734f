"""The port's card checks, in a file that imports neither JAX nor the JAX
reference package, so that it runs where the card is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each test launches a CUDA kernel and holds it against its plain PyTorch
version on the same card (bitwise, but flash attention: 2e-5 in float32,
2e-2 for bf16 inputs), or counts the launches of a path.  They carry the
checks of the ``cuda`` tests in ``test_torch_kernels.py``,
``test_torch_chunk.py``, ``test_torch_lm_kernels.py`` and
``test_torch_serve.py`` (files that import the reference), plus
``run_plan`` on the card: a padded-jobs point equals the same point run
alone; the paper's F1..F6 in both CC kernels; and the armed chunk kernel
(telemetry and faults, and the fig 5 and churn plans' specializations at
their widths) against the per-tick
path, its sketch bins against torch's, and a plan with
telemetry and a fault-schedule axis on the kernel.  Without a card every
test skips, with its reason.
"""
import dataclasses

import numpy as np
import pytest

from _torch_reference import random_feedback_arrays, random_protocol_arrays

import torch

from repro_torch import core, netsim, workload
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import netsim_chunk as nc
from repro_torch.kernels import ref
from repro_torch.kernels import rg_lru as rl
from repro_torch.models import api
from repro_torch.netsim import engine, experiment, telemetry

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_a_card():
    # decided per test, never at import: every worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs these checks on the card)")

DT = 2e-5
RED_ECN = dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2)


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):          # a TelemetryState's probe rings
        tree = list(tree.values())
    return [x for v in tree for x in _leaves(v)]


def _bits(x):
    """A leaf as host bytes, so float leaves compare bitwise (NaNs too)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:     # numpy has no bfloat16
            x = x.view(torch.int16)
        x = x.cpu().numpy()
    return np.array(x).reshape(-1).view(np.uint8)


def _assert_bitwise(got, want):
    la, lb = _leaves(got), _leaves(want)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert tuple(x.shape) == tuple(y.shape), i
        assert np.array_equal(_bits(x), _bits(y)), f"leaf {i} differs"


# ---------------------------------------------------------------------------
# the CC tick and the chunk kernel
# ---------------------------------------------------------------------------

def test_cuda_cc_kernel_equals_plain_version_bitwise():
    rng = np.random.default_rng(9)
    k, n = 2, 41
    dev = torch.device("cuda")
    arrs = random_protocol_arrays(rng, (k, n))
    fb = random_feedback_arrays(rng, (k, n))
    total = rng.uniform(1e7, 2e8, (k, n)).astype(np.float32)
    factors = np.where(rng.uniform(size=(k, n)) < 0.5,
                       rng.uniform(0.25, 2.0, (k, n)), -1.0).astype(np.float32)
    det, cc = arrs["det"], arrs["cc"]
    arrays = {f: det[f] for f in ms.DET_FIELDS}
    arrays.update({f: cc[f] for f in ms.CC_FIELDS})
    arrays.update(stage=cc["inc_stage"], prev_ratio=det["bytes_ratio"],
                  num_acks=fb["num_acks"],
                  ack_bytes=fb["num_acks"] * np.float32(1500.0),
                  loss=fb["loss"], cnp=fb["cnp"], total_bytes=total,
                  job_numer=total * np.float32(0.5))
    arrays = {f: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for f, v in arrays.items()}
    dyn = core.DynamicParams(
        *[torch.tensor(v, dtype=torch.float32) for v in
          ([1.75, 1.3], [0.25, 0.4], [0.75, 0.8], [0.5, 0.45],
           [1e-3, 2e-3])]).stacked().to(dev)
    now = torch.tensor([0.0123, 0.0171], device=dev)
    fac = torch.from_numpy(factors).to(dev)
    for algo in (0, 1, 2):
        p = ms.static_params(core.CCParams(algo=algo, variant=3),
                             aggregate=True)
        before = ms.LAUNCH_COUNT
        got = ms.mltcp_tick(p, dyn, arrays, now, fac)
        assert ms.LAUNCH_COUNT == before + 1
        want = ms.mltcp_tick_reference(p, dyn, arrays, now, fac)
        for name in ms.OUT_ORDER:
            assert np.array_equal(_bits(got[name]), _bits(want[name])), \
                (algo, name)


F_FAMILIES = ("F1", "F2", "F3", "F4", "F5", "F6")


@pytest.mark.parametrize("f_spec", F_FAMILIES)
def test_cuda_cc_kernel_f_family_equals_plain_version_bitwise(f_spec):
    """The launch's F id computes the F family op for op as
    `core.aggressiveness` (WI, MD and both, with and without factors)."""
    rng = np.random.default_rng(13)
    k, n = 3, 257
    dev = torch.device("cuda")
    arrs = random_protocol_arrays(rng, (k, n))
    fb = random_feedback_arrays(rng, (k, n))
    total = rng.uniform(1e7, 2e8, (k, n)).astype(np.float32)
    det, cc = arrs["det"], arrs["cc"]
    arrays = {f: det[f] for f in ms.DET_FIELDS}
    arrays.update({f: cc[f] for f in ms.CC_FIELDS})
    arrays.update(stage=cc["inc_stage"], prev_ratio=det["bytes_ratio"],
                  num_acks=fb["num_acks"],
                  ack_bytes=fb["num_acks"] * np.float32(1500.0),
                  loss=fb["loss"], cnp=fb["cnp"], total_bytes=total,
                  job_numer=total * rng.uniform(0, 1.2, (k, n)).astype(
                      np.float32))
    arrays = {f: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for f, v in arrays.items()}
    dyn = core.DynamicParams(
        *[torch.tensor(v, dtype=torch.float32) for v in
          ([1.75, 1.3, 0.5], [0.25, 0.4, 1.0], [0.75, 0.8, 0.7],
           [0.5, 0.45, 0.6], [1e-3, 2e-3, 1.5e-3])]).stacked().to(dev)
    now = torch.tensor([0.0123, 0.0171, 0.02], device=dev)
    fac = torch.where(torch.rand((k, n), device=dev) < 0.5,
                      torch.rand((k, n), device=dev) + 0.25, -1.0)
    for algo in (0, 1, 2):
        for variant in (1, 2, 3):
            for factors in (None, fac):
                p = ms.static_params(core.CCParams(algo=algo,
                                                   variant=variant),
                                     aggregate=True, f_spec=f_spec)
                assert p["f_id"] == ms.F_IDS[f_spec]
                got = ms.mltcp_tick(p, dyn, arrays, now, factors)
                want = ms.mltcp_tick_reference(p, dyn, arrays, now, factors)
                for name in ms.OUT_ORDER:
                    assert np.array_equal(_bits(got[name]),
                                          _bits(want[name])), \
                        (algo, variant, factors is not None, name)


def _cfg(algo=0, variant=1, n_jobs=2, spj=2, topo=None, jobs=None,
         sim_time=0.02, f_spec="linear", aggregate_by_job=True, **kw):
    return netsim.SimConfig(
        topo=topo or netsim.dumbbell(n_jobs, sockets_per_job=spj),
        jobs=jobs or netsim.JobSpec.simple([0.0025] * n_jobs,
                                           [5e6] * n_jobs),
        protocol=core.MLTCPConfig(
            cc=core.CCParams(algo=algo, variant=variant, tick_dt=DT,
                             rtt=100e-6), slope=1.75, intercept=0.25,
            f_spec=f_spec, aggregate_by_job=aggregate_by_job),
        sim_time=sim_time, dt=DT, seed=3, n_chunks=10, **kw)


def _two_tier_cfg():
    profiles = [workload.profile_for("gpt3_hybrid").scaled(0.05),
                workload.profile_for("gpt2").scaled(0.05),
                workload.profile_for("gpt2").scaled(0.05)]
    return _cfg(topo=netsim.two_tier([(0, 1), (1, 2), (3, 0)],
                                     sockets_per_job=2),
                jobs=workload.jobspec_from_profiles(profiles), n_jobs=3)


def _triangle_cassini_case():
    profiles = [workload.profile_for("gpt2").scaled(0.05) for _ in range(3)]
    topo = netsim.triangle(sockets_per_job=2)
    sched, feasible = workload.cassini_schedule(topo, profiles)
    assert not feasible
    return (_cfg(algo=2, variant=0, n_jobs=3, topo=topo, cassini=sched,
                 sim_time=0.04,
                 jobs=workload.jobspec_from_profiles(profiles), **RED_ECN),
            dict(seed=[3, 5]))


# name -> (config, sweep overrides) of the chunk kernel against the
# per-tick path: Reno WI, DCQCN with ECN, the leaf/spine fabric, each F
# family on Reno WI at fig 15's width (three jobs), and the shapes of the
# figure plans that only they drive: fig 14's triangle with its Cassini
# schedule on DCQCN OFF, Table 2's one-hot job masks on its two-tier
# fabric, fig 13's Static factors beside the adaptive sentinel at 3 jobs
CHUNK_CASES = {
    "reno_wi": lambda: (_cfg(), dict(seed=[3, 5])),
    "dcqcn_wi_ecn": lambda: (_cfg(algo=2, spj=1, **RED_ECN),
                             dict(seed=[3, 5])),
    "two_tier": lambda: (_two_tier_cfg(), dict(seed=[3, 5])),
    **{f"reno_wi_{f}": (lambda f=f: (_cfg(n_jobs=3, f_spec=f),
                                     dict(seed=[3, 5])))
       for f in F_FAMILIES},
    "dcqcn_off_triangle_cassini": _triangle_cassini_case,
    "dcqcn_wi_two_tier_solo": lambda: (
        _cfg(algo=2, topo=netsim.two_tier([(0, 1), (2, 1)], n_leaves=4,
                                          sockets_per_job=2), **RED_ECN),
        dict(seed=[3, 5, 3], job_active=[[True, True], [True, False],
                                         [False, True]])),
    "dcqcn_wi_static_3jobs": lambda: (
        _cfg(algo=2, n_jobs=3, **RED_ECN),
        dict(seed=[3, 5], static_job_factors=[[1.3, 1.0, 0.7],
                                              [-1.0, -1.0, -1.0]])),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_cuda_chunk_kernel_equals_per_tick_path_bitwise(case):
    from repro_torch.kernels import ops

    cfg, overrides = CHUNK_CASES[case]()
    sweep = netsim.make_sweep(cfg, device="cuda", **overrides)
    assert ops.chunk_fallback_reason(cfg, sweep) is None
    before = nc.LAUNCH_COUNT
    got = engine.run_ticks(cfg, sweep)
    assert nc.LAUNCH_COUNT - before == cfg.n_chunks
    want = engine.run_ticks(cfg, sweep, per_tick=True)
    _assert_bitwise(got, want)


def _armed_cfg(algo, **kw):
    """Every built-in probe and detector, all four fault channels, and the
    sweep overrides of a schedule that uses them (point 0) beside the
    identity schedule (point 1)."""
    cfg = _cfg(algo=algo, n_jobs=3, sim_time=0.03, telemetry=(
        telemetry.TelemetrySpec(probes=telemetry.BUILTIN_PROBES, stride=7,
                                detectors=telemetry.DETECTORS)),
        faults=netsim.FaultSpec(n_events=10, churn=True, link_flaps=True,
                                blackholes=True, straggle_bursts=True), **kw)
    t = cfg.sim_time
    sched = netsim.fault_schedule(cfg, [
        netsim.job_departs(0.2 * t, 2), netsim.job_arrives(0.45 * t, 2),
        netsim.link_flap(0.3 * t, 0.6 * t, 0, 0.5),
        netsim.blackhole(0.1 * t, 0.35 * t, [0]),
        netsim.straggle_burst(0.05 * t, 0.7 * t, 0.5)], spec=cfg.faults)
    ident = netsim.identity_schedule(cfg, cfg.faults)
    return cfg, {f: np.stack([sched.values[f], ident.values[f]])
                 for f in sched.values}


@pytest.mark.parametrize("algo", [0, 1, 2])
def test_cuda_armed_chunk_kernel_equals_per_tick_path_bitwise(algo):
    cfg, overrides = _armed_cfg(algo, **(RED_ECN if algo == 2 else {}))
    sweep = netsim.make_sweep(cfg, device="cuda", seed=[3, 5], **overrides)
    before = nc.LAUNCH_COUNT
    got = engine.run_ticks(cfg, sweep)
    assert nc.LAUNCH_COUNT - before == cfg.n_chunks
    want = engine.run_ticks(cfg, sweep, per_tick=True)
    _assert_bitwise(got, want)
    assert int(want.iter_counts.sum()) > 0
    assert int(want.telemetry.n_samples.min()) > 0


# the CC selections the armed kernel takes as launch dims, beyond WI with
# job statistics: MD, BOTH, per-flow statistics, Static factors beside the
# adaptive sentinel (-1)
ARMED_SELECTIONS = {
    "md": dict(variant=2),
    "both": dict(variant=3),
    "per_flow_stats": dict(aggregate_by_job=False),
    "static_factors": dict(static_job_factors=np.asarray([1.3, -1.0, 0.7])),
}


@pytest.mark.parametrize("selection", sorted(ARMED_SELECTIONS))
@pytest.mark.parametrize("algo", [0, 1, 2])
def test_cuda_armed_kernel_on_every_specialization_bitwise(algo, selection):
    """Telemetry and faults armed on MD, BOTH, per-flow statistics or
    Static factors: the armed kernel (one per algorithm and ARMED, the
    selections as launch dims) equals the per-tick path on every leaf and
    spills nothing."""
    cfg, overrides = _armed_cfg(algo, **ARMED_SELECTIONS[selection],
                                **(RED_ECN if algo == 2 else {}))
    sweep = netsim.make_sweep(cfg, device="cuda", seed=[3, 5], **overrides)
    before = nc.LAUNCH_COUNT
    got = engine.run_ticks(cfg, sweep)
    assert nc.LAUNCH_COUNT - before == cfg.n_chunks
    want = engine.run_ticks(cfg, sweep, per_tick=True)
    _assert_bitwise(got, want)
    assert int(want.iter_counts.sum()) > 0
    assert int(want.telemetry.n_samples.min()) > 0
    from repro_torch.analysis import kernel_lint
    attrs = nc.kernel_attributes(*kernel_lint.specialization_of(cfg, sweep))
    assert attrs["local_bytes"] == 0, attrs


# the fig 5 plan's and the churn gauntlet's specializations at their
# widths: (algo, sockets a job), DCQCN one socket a job
SUITE_WIDTHS = [(0, 2), (1, 2), (2, 1)]


def _suite_cfg(suite, algo, spj, variant):
    """The fig 5 plan's telemetry alone (its seven probes, stride 75, the
    default detectors) on 2 jobs, or the churn gauntlet's telemetry and
    faults on 3 jobs at 100 Gbps, with the sweep overrides of two
    schedules (points 0 and 1)."""
    red = RED_ECN if algo == 2 else {}
    if suite == "fig5":
        return _cfg(algo=algo, variant=variant, spj=spj, telemetry=(
            telemetry.TelemetrySpec(
                probes=("flow_cwnd", "flow_rate", "link_queue",
                        "link_mark_rate", "job_incomm", "job_iter",
                        "interleave_overlap"), stride=75)), **red), {}
    spec = netsim.FaultSpec(n_events=8, churn=True, link_flaps=True,
                            blackholes=True)
    cfg = _cfg(algo=algo, variant=variant, n_jobs=3, topo=netsim.dumbbell(
        3, sockets_per_job=spj, cap_gbps=100.0), telemetry=(
            telemetry.TelemetrySpec(
                probes=("interleave_overlap", "job_iter"),
                detectors=telemetry.DETECTORS, overlap_threshold=0.8,
                stride=225)), faults=spec, **red)
    t = cfg.sim_time
    scheds = [netsim.fault_schedule(cfg, [
        netsim.job_departs(0.0, job), netsim.job_arrives(0.1 * t, job),
        netsim.job_departs(0.3 * t, job), netsim.job_arrives(0.4 * t, job),
        netsim.link_flap(0.5 * t, 0.65 * t, 0, 0.9),
        netsim.blackhole(0.2 * t, 0.25 * t, [0])], spec=spec)
        for job in (2, 1)]
    return cfg, {f: np.stack([sc.values[f] for sc in scheds])
                 for f in scheds[0].values}


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("algo,spj", SUITE_WIDTHS)
@pytest.mark.parametrize("suite", ["fig5", "churn"])
def test_cuda_suite_armed_kernel_equals_per_tick_path_bitwise(
        suite, algo, spj, variant):
    """The armed specializations the fig 5 plan (telemetry alone) and the
    churn gauntlet (telemetry and faults) run, OFF and WI, at their
    widths: the chunk kernel equals the per-tick path on every leaf."""
    cfg, overrides = _suite_cfg(suite, algo, spj, variant)
    sweep = netsim.make_sweep(cfg, device="cuda", seed=[3, 5], **overrides)
    before = nc.LAUNCH_COUNT
    got = engine.run_ticks(cfg, sweep)
    assert nc.LAUNCH_COUNT - before == cfg.n_chunks
    want = engine.run_ticks(cfg, sweep, per_tick=True)
    _assert_bitwise(got, want)
    assert int(want.iter_counts.sum()) > 0
    assert int(want.telemetry.n_samples.min()) > 0


def test_cuda_sketch_bins_equal_torch():
    """The kernel's logf and sketch bins against torch.log and
    `telemetry.sketch_bins` on the card, on 2**22 float32 values spread
    over and past [sketch_lo, sketch_hi] (chip_smoke.py checks every
    float32 in the range)."""
    spec = telemetry.TelemetrySpec()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    x = torch.exp(torch.empty(2 ** 22, device="cuda").uniform_(
        np.log(1e-6), np.log(1e3), generator=gen))
    logs, bins = nc.sketch_check(x, spec)
    assert torch.equal(logs.view(torch.int32),
                       torch.log(x).view(torch.int32))
    assert torch.equal(bins, telemetry.sketch_bins(x, spec))


def test_cuda_plan_with_telemetry_and_faults_runs_on_the_kernel():
    """run_plan with a telemetry spec and a fault-schedule axis
    (``field="*"``): one group, one launch per chunk, no fallback, and the
    re-interleave detector reports every observed window."""
    spec = netsim.FaultSpec(n_events=5, churn=True, link_flaps=True)

    def schedule(label):
        def resolve(cfg):
            t = cfg.sim_time
            events = [netsim.job_departs(0.2 * t, 1),
                      netsim.job_arrives(0.5 * t, 1)]
            if label == "flap":
                events.append(netsim.link_flap(0.6 * t, 0.8 * t, 0, 0.5))
            return netsim.fault_schedule(cfg, events, spec=spec).overrides()
        return resolve
    plan = netsim.Plan(name="tele-faults", build=lambda pt: _cfg(
        sim_time=0.04, faults=spec), axes=(
        netsim.Axis("schedule", ("churn", "flap"), field="*",
                    resolve=schedule),
        netsim.Axis("seed", (3, 4))))
    tel = telemetry.TelemetrySpec(
        probes=("interleave_overlap", "job_iter"), stride=10,
        detectors=("interleave", "iter_sketch", "reinterleave"))
    before = nc.LAUNCH_COUNT
    pr = netsim.run_plan(plan, telemetry=tel)
    assert pr.n_compile_groups == 1 and pr.n_kernel_fallbacks == 0
    assert nc.LAUNCH_COUNT - before == pr.n_kernel_launches == 10
    for r in pr:
        assert r.telemetry.fault_events
        assert r.telemetry.series["job_iter"].shape[1] == 2


# ---------------------------------------------------------------------------
# run_plan on the card
# ---------------------------------------------------------------------------

def test_cuda_run_plan_padded_point_equals_unpadded_run():
    """A two-job point of a padded job-count group, run through run_plan's
    sweep on the card, equals the same point alone on its own fabric on
    every output leaf (the active jobs and flows); the plan itself runs
    one group of one launch per chunk."""
    def build(pt):
        return _cfg(n_jobs=pt["n_jobs"])
    plan = netsim.Plan(name="padded", build=build, axes=(
        netsim.Axis("n_jobs", (2, 3)), netsim.Axis("seed", (3, 4))))
    before = nc.LAUNCH_COUNT
    pr = netsim.run_plan(plan)
    assert pr.n_compile_groups == 1 and pr.n_kernel_fallbacks == 0
    assert nc.LAUNCH_COUNT - before == pr.n_kernel_launches == 10
    assert all(len(x) > 0 for r in pr for x in r.iter_times)
    points, cfgs, overrides, groups = experiment.resolve_plan(plan)
    (group,) = groups
    padded = netsim.simulate_sweep(
        group.cfg, experiment.group_sweep(cfgs, overrides, group))
    slot = group.idxs.index(1)                  # n_jobs=2, seed=4
    alone = netsim.simulate_sweep(
        cfgs[1], netsim.make_sweep(cfgs[1], device="cuda", seed=[4]))
    got = [x[slot] for x in _leaves(padded)]
    want = [x[0] for x in _leaves(alone)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g[tuple(slice(0, s) for s in w.shape)]
        assert tuple(g.shape) == tuple(w.shape), i
        assert np.array_equal(_bits(g), _bits(w)), f"leaf {i} differs"
    # the run_plan results are the padded run's
    (res,) = pr.select(n_jobs=2, seed=4)
    for j in range(2):
        n = int(padded.iter_counts[slot, j])
        np.testing.assert_array_equal(res.iter_times[j],
                                      padded.iter_times[slot, j, :n].cpu())


# ---------------------------------------------------------------------------
# the language-model kernels and the serve prefill
# ---------------------------------------------------------------------------

# (b, t, s, h, kv, dh, causal, window, softcap, dtype), as in
# tests/test_kernels.py
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, None, torch.float32),
    (1, 256, 256, 4, 2, 64, True, 0, None, torch.float32),
    (2, 128, 128, 4, 1, 32, True, 0, None, torch.float32),
    (1, 256, 256, 2, 2, 128, True, 64, None, torch.float32),
    (1, 128, 128, 2, 2, 64, True, 0, 50.0, torch.float32),
    (2, 128, 128, 4, 4, 64, False, 0, None, torch.float32),
    (1, 192, 192, 2, 2, 64, True, 0, None, torch.float32),
    (2, 128, 128, 4, 4, 64, True, 0, None, torch.bfloat16),
]


def test_cuda_rg_lru_kernel_equals_plain_version_bitwise():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # ((b, t, d), bytes of `a`'s storage offset): a whole number of 16-row
    # tiles, a ragged D (general route), T = 1, T below one tile, a ragged
    # T with a ragged last unit (aligned route), an operand 4 bytes off
    for (b, t, d), offset in (((2, 64, 128), 0), ((3, 33, 130), 0),
                              ((2, 1, 256), 0), ((2, 9, 256), 0),
                              ((2, 77, 136), 0), ((2, 70, 256), 4)):
        for dtype in (torch.float32, torch.bfloat16):
            skip = offset // dtype.itemsize
            a = torch.empty(skip + b * t * d, dtype=dtype, device=dev
                            )[skip:].view(b, t, d)
            a.copy_(torch.rand((b, t, d), generator=gen, device=dev) * 0.8
                    + 0.2)
            x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
            h0 = torch.randn((b, d), generator=gen, device=dev).to(dtype)
            for hh in (None, h0):
                before = rl.LAUNCH_COUNT
                got = rl.rg_lru(a, x, hh)
                assert rl.LAUNCH_COUNT == before + 1
                want = ref.ref_rg_lru(a, x, hh)
                assert np.array_equal(_bits(got), _bits(want)), \
                    ((b, t, d), offset, dtype, hh is not None)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_cuda_flash_kernel_matches_plain_version(case):
    b, t, s, h, kv, dh, causal, window, softcap, dtype = case
    rng = np.random.default_rng(1)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to("cuda", dtype) for shape in ((b, t, h, dh), (b, s, kv, dh),
                                                (b, s, kv, dh))]
    before = fa.LAUNCH_COUNT
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    assert fa.LAUNCH_COUNT == before + 1
    want = ref.ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_cuda_kernels_backward_equals_autograd_through_plain_versions():
    """Both LM kernels take inputs that need a gradient: the RG-LRU
    backward (one more launch, the reverse scan) equals autograd through
    the sequential loop bit for bit, flash's recomputed VJP equals autograd
    through the dense attention; the forward launches are counted."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    for (b, t, d), dtype, with_h0 in ((2, 33, 130), torch.float32, True), \
            ((2, 1, 256), torch.float32, True), \
            ((2, 40, 2560), torch.float32, False), \
            ((3, 17, 136), torch.bfloat16, True):
        a = (torch.rand((b, t, d), generator=gen, device=dev) * 0.79
             + 0.2).to(dtype)
        x, g = (torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        h0 = torch.randn((b, d), generator=gen, device=dev).to(dtype)
        ins = [a, x] + ([h0] if with_h0 else [])
        mine = [v.clone().requires_grad_(True) for v in ins]
        before = rl.LAUNCH_COUNT
        got = torch.autograd.grad(rl.rg_lru(*mine), mine, g)
        assert rl.LAUNCH_COUNT == before + 2
        theirs = [v.clone().requires_grad_(True) for v in ins]
        want = torch.autograd.grad(ref.ref_rg_lru(*theirs), theirs, g)
        for name, x_got, x_want in zip(("da", "db", "dh0"), got, want):
            assert torch.equal(x_got, x_want), ((b, t, d), dtype, name)

    q = torch.randn((1, 70, 4, 64), generator=gen, device=dev)
    kv = [torch.randn((1, 70, 2, 64), generator=gen, device=dev)
          for _ in range(2)]
    g = torch.randn((1, 70, 4, 64), generator=gen, device=dev)
    mine = [v.clone().requires_grad_(True) for v in (q, *kv)]
    before = fa.LAUNCH_COUNT
    got = torch.autograd.grad(
        fa.flash_attention(*mine, causal=True, window=16), mine, g)
    assert fa.LAUNCH_COUNT == before + 1
    theirs = [v.clone().requires_grad_(True) for v in (q, *kv)]
    want = torch.autograd.grad(
        ref.ref_attention(*theirs, causal=True, window=16), theirs, g)
    for name, x_got, x_want in zip("qkv", got, want):
        assert torch.equal(x_got, x_want), name


def test_cuda_prefill_default_launches_the_kernels():
    cfg = get_config("recurrentgemma-2b").scaled_down(window=5)
    dev = torch.device("cuda")
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                            device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 11), device=dev)}
    before = (fa.LAUNCH_COUNT, rl.LAUNCH_COUNT)
    with torch.no_grad():
        api.prefill(cfg, model, batch, 24)
    kinds = [blk.kind for blk in model.layers]
    assert (fa.LAUNCH_COUNT - before[0], rl.LAUNCH_COUNT - before[1]) == \
        (kinds.count("attn_local"), kinds.count("rec"))


# the new families, scaled down: (arch, overrides, flash launches a prefill)
FAMILIES = [("deepseek-moe-16b", {}, 2),        # 2 causal attention layers
            ("seamless-m4t-medium", {}, 4),     # 2 encoder + 2 decoder self
            ("xlstm-125m", {}, 0)]              # no kernel on its path
FAMILY_REL_BOUND = 1e-3     # chip_smoke.py's kernel path vs plain path


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch,over,flash", FAMILIES, ids=str)
def test_cuda_family_prefill_kernel_path_equals_plain_path(arch, over, flash):
    """The MoE, encoder-decoder and xLSTM stacks on the card: the default
    prefill launches flash for each self-attention layer (bidirectional in
    the encoder) and never for cross-attention, and agrees with the plain
    path within FAMILY_REL_BOUND of its largest logit and cache entry."""
    cfg = get_config(arch).scaled_down(**over)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    model = api.init_params(cfg, gen, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                                     device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, 10, cfg.d_model), generator=gen,
                                      device=dev)
    before = fa.LAUNCH_COUNT
    with torch.no_grad():
        lk, ck = api.prefill(cfg, model, batch, 48)
        assert fa.LAUNCH_COUNT - before == flash
        lp, cp = api.prefill(cfg, model, batch, 48, use_kernel=False)
    assert fa.LAUNCH_COUNT - before == flash
    assert bool(torch.isfinite(lk).all())
    assert _rel(lk, lp) <= FAMILY_REL_BOUND
    for i in cp:
        for name in cp[i]:
            assert _rel(ck[i][name], cp[i][name]) <= FAMILY_REL_BOUND, \
                (i, name)


# flash launches of one kernel-path loss and gradient, forward and remat
# recompute: deepseek's dense lead layer is not rematerialized, its MoE
# layer is (a group of its pattern); the encoder-decoder rematerializes
# every block
TWO_LAYER_FLASH = {"deepseek-moe-16b": 2 + 1, "seamless-m4t-medium": 4 + 4}


@pytest.mark.parametrize("arch", list(TWO_LAYER_FLASH))
def test_cuda_full_width_two_layers_loss_and_gradients_kernel_vs_plain(arch):
    """Full published widths cut to two layers (seamless: two encoder and
    two decoder layers), 1 x 256 tokens: the loss and every gradient leaf
    through the kernels (flash forward and its dense VJP, the encoder's
    bidirectional) within FAMILY_REL_BOUND of the plain path's."""
    from repro_torch.train import TrainHyper, loss_fn

    over = dict(n_layers=2)
    if arch == "seamless-m4t-medium":
        over["enc_layers"] = 2
    cfg = dataclasses.replace(get_config(arch), **over)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    model = api.init_params(cfg, gen, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 256), generator=gen,
                                     device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((1, 64, cfg.d_model), generator=gen,
                                      device=dev)
    params = dict(model.named_parameters())
    out = []
    for use_kernel in (True, False):
        before = fa.LAUNCH_COUNT
        loss, metrics = loss_fn(cfg, model, batch,
                                TrainHyper(use_kernel=use_kernel))
        grads = torch.autograd.grad(loss, list(params.values()))
        launched = fa.LAUNCH_COUNT - before
        out.append((loss.detach(), dict(zip(params, grads)), launched))
        del grads
    (lk, gk, nk), (lp, gp, np_) = out
    assert (nk, np_) == (TWO_LAYER_FLASH[arch], 0)
    assert bool(torch.isfinite(lk))
    assert float(abs(lk - lp) / abs(lp)) <= FAMILY_REL_BOUND
    for name in gp:
        assert _rel(gk[name], gp[name]) <= FAMILY_REL_BOUND, name


# ---------------------------------------------------------------------------
# the static verifier's launch contract, read from the library
# ---------------------------------------------------------------------------

def _ci_groups():
    """(label, group config, its CPU sweep) of every group the analysis
    gate proves: the five CI plans, fig 5 armed and unarmed."""
    from repro_torch.analysis import plans

    for name in plans.CI_PLANS:
        plan, tel, lint_unarmed = plans.resolve_entry(name)
        variants = [(name, tel)] + ([(f"{name}[unarmed]", None)]
                                    if lint_unarmed else [])
        for label, telemetry in variants:
            _, cfgs, overrides, groups = experiment.resolve_plan(
                plan, telemetry=telemetry)
            for gi, g in enumerate(groups):
                yield (f"{label}/group{gi}", g.cfg,
                       experiment.group_sweep(cfgs, overrides, g,
                                              device="cpu"))


def test_analysis_library_smem_equals_prediction_for_ci_groups():
    from repro_torch.analysis import kernel_lint

    n = 0
    for label, cfg, sweep in _ci_groups():
        setup = kernel_lint.launch_setup(cfg, sweep)
        findings, facts = kernel_lint.lint_library(cfg, sweep, label=label,
                                                   setup=setup)
        assert facts["library_smem_bytes"] == nc.smem_bytes(
            **nc.shape_of(cfg)), label
        assert findings == [], findings
        n += 1
    assert n == 23


def test_analysis_ci_specializations_do_not_spill():
    from repro_torch.analysis import kernel_lint

    specs = {kernel_lint.specialization_of(cfg, sweep)
             for _, cfg, sweep in _ci_groups()}
    assert specs <= kernel_lint.built_specializations()
    for spec in sorted(specs):
        attrs = nc.kernel_attributes(*spec)
        assert attrs["local_bytes"] == 0, (spec, attrs)
        assert attrs["max_threads"] >= nc.MAX_THREADS, (spec, attrs)


# ---------------------------------------------------------------------------
# the dry run: meta counts against the card
# ---------------------------------------------------------------------------

DRYRUN_CELLS = [("recurrentgemma-2b", "prefill_32k"),
                ("recurrentgemma-2b", "train_4k"),
                ("qwen3-1.7b", "prefill_32k"),
                ("qwen3-1.7b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", DRYRUN_CELLS, ids=str)
def test_cuda_dryrun_planned_launches_equal_the_cards(arch, shape):
    """One scaled-down cell counted on the meta device, then run on the
    card (bf16 serving; a train cell with one microbatch): the kernels'
    launches equal the planned ones.  (The peak is held at full width in
    chip_smoke.py: at these widths the allocator's 512-byte rounding of
    small tensors outweighs them.)"""
    from repro_torch.launch import dryrun as dr

    cfg = get_config(arch).scaled_down(window=16)
    meta = dr.count_cell(dr.build_cell(cfg, shape, 2, seq_len=96,
                                       microbatches=1))
    cell = dr.build_cell(cfg, shape, 2, device="cuda", seq_len=96,
                         microbatches=1, seed=3)
    for _ in range(2):                  # cold, then warm
        before = (fa.LAUNCH_COUNT, rl.LAUNCH_COUNT)
        cell.step(*cell.args)
        torch.cuda.synchronize()
        assert {"flash_attention": fa.LAUNCH_COUNT - before[0],
                "rg_lru": rl.LAUNCH_COUNT - before[1]} == \
            meta["planned_launches"]
