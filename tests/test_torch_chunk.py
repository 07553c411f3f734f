"""The simulator's chunk kernel (``kernels/netsim_chunk.py``): its operand
packing, shared-memory budget, dispatch and build, and its logic.

* The kernel's source compiles for the CPU too: a host C++ compiler builds
  its body with ``csrc/host_compat.cuh`` standing in for the CUDA keywords
  (each CTA a few host threads meeting at a barrier).  That build runs
  whole simulations and must equal the plain version (the per-tick loop,
  `engine.run_chunk_reference`) bit for bit on every leaf of the state and
  of the traces, for each algorithm, variant and engine option, and it
  holds the JAX reference's trajectory as `test_torch_engine` does.  The
  CUDA build itself runs only on the card: ``chip_smoke.py`` holds it
  against the per-tick path there, and the ``cuda`` test below does when a
  card is present.
* Packing an `EngineState`, the run's statics and sweep values and a
  chunk's inputs into the kernel's flat operands, and back, is exact.
* The armed kernel (telemetry and faults, the template's ARMED) equals the
  per-tick path bit for bit on every leaf, the telemetry state's
  included, for each algorithm, with telemetry, faults or both armed; a
  spec it cannot run (a custom probe, an uninstantiated specialization)
  takes the per-tick path, counted.
* The enums of ``csrc/netsim_chunk.cu`` and ``csrc/mltcp_cc.cuh`` are the
  wrapper's name lists, in order.
* The budget admits every fabric the figure suites build and sends an
  oversized one to the per-tick path, counted and warned once.
* A CPU run never loads a kernel library; a changed header rebuilds.
"""
import dataclasses
import re
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest

from _torch_host_chunk import (build_host_library, compiler, host_launch,
                               host_run_ticks)
from _torch_reference import load_reference

import torch

from repro_torch import core, netsim, workload
from repro_torch.kernels import build, ops
from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import netsim_chunk as nc
from repro_torch.netsim import engine
from repro_torch.netsim import faults
from repro_torch.netsim import random as rng
from repro_torch.netsim import telemetry

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
DT = 2e-5
DEV = torch.device("cpu")
RED_ECN = dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2)


def _cfg(algo=0, variant=1, n_jobs=2, spj=2, sim_time=0.02, topo=None,
         jobs=None, proto=None, n_chunks=10, **kw):
    protocol = core.MLTCPConfig(
        cc=core.CCParams(algo=algo, variant=variant, tick_dt=DT, rtt=100e-6),
        slope=1.75, intercept=0.25, **(proto or {}))
    return netsim.SimConfig(
        topo=topo or netsim.dumbbell(n_jobs, sockets_per_job=spj),
        jobs=jobs or netsim.JobSpec.simple([0.0025] * n_jobs,
                                           [5e6] * n_jobs),
        protocol=protocol, sim_time=sim_time, dt=DT, seed=3,
        n_chunks=n_chunks, **kw)


def _two_tier_cfg(**kw):
    """Fig. 6(b)'s leaf/spine (M=9) with a GPT-3 hybrid job (4 phases)
    beside two data-parallel ones."""
    profiles = [workload.profile_for("gpt3_hybrid").scaled(0.05),
                workload.profile_for("gpt2").scaled(0.05),
                workload.profile_for("gpt2").scaled(0.05)]
    return _cfg(topo=netsim.two_tier([(0, 1), (1, 2), (3, 0)],
                                     sockets_per_job=2),
                jobs=workload.jobspec_from_profiles(profiles), n_jobs=3,
                **kw)


# name -> (config, sweep overrides): Reno/CUBIC/DCQCN, OFF/WI/MD/BOTH,
# Static factors, per-flow statistics, Cassini with stragglers, padded
# jobs, the fig 10 width and the leaf/spine fabric
CASES = {
    "reno_wi": (_cfg(), dict(seed=[3, 5])),
    "reno_off": (_cfg(variant=0), dict(seed=[3, 5])),
    "reno_md_factors": (_cfg(variant=2,
                             static_job_factors=np.asarray([0.6, -1.0])),
                        dict(seed=[3, 5])),
    "cubic_wi": (_cfg(algo=1), dict(seed=[3, 5])),
    "cubic_both_no_reset": (_cfg(algo=1, variant=3,
                                 cubic_epoch_reset_on_comm_start=False),
                            dict(seed=[3, 5])),
    "dcqcn_wi_ecn": (_cfg(algo=2, spj=1, **RED_ECN), dict(seed=[3, 5])),
    "reno_per_flow_stats": (_cfg(proto=dict(aggregate_by_job=False)),
                            dict(seed=[3, 5])),
    "reno_cassini_stragglers": (
        _cfg(cassini=netsim.CassiniSchedule(
            offset=np.asarray([0.0, 0.004]), period=np.asarray([0.01, 0.0]),
            eps=1e-3)),
        dict(seed=[3, 5], straggle_prob=[[0.5, 0.5], [0.3, 0.0]])),
    "reno_padded_jobs": (_cfg(n_jobs=3),
                         dict(seed=[3, 5], job_active=[[True, True, False],
                                                       [True, False, True]])),
    "fig10_width": (_cfg(n_jobs=6),
                    dict(seed=[1, 1, 1, 1], job_active=[
                        [j < n for j in range(6)] for n in (2, 3, 4, 6)])),
    "two_tier": (_two_tier_cfg(), dict(seed=[3, 5])),
}


def _armed(algo=0, variant=1, spj=2, n_jobs=3, tel=True, flt=True,
           detectors=telemetry.DETECTORS, job_active=None, **kw):
    """A config with telemetry (every built-in probe) and/or faults (all
    four channels) armed, and its sweep overrides: point 0 under a
    schedule that departs and re-admits the last job, flaps the
    bottleneck, blackholes flow 0 and bursts the straggle probability,
    point 1 under the identity schedule."""
    cfg = _cfg(algo=algo, variant=variant, spj=spj, n_jobs=n_jobs, **kw)
    if tel:
        cfg = dataclasses.replace(cfg, telemetry=telemetry.TelemetrySpec(
            probes=telemetry.BUILTIN_PROBES, stride=7, detectors=detectors))
    overrides = dict(seed=[3, 5])
    if job_active is not None:
        overrides["job_active"] = job_active
    if flt:
        spec = faults.FaultSpec(n_events=10, churn=True, link_flaps=True,
                                blackholes=True, straggle_bursts=True)
        cfg = dataclasses.replace(cfg, faults=spec)
        t = cfg.sim_time
        sched = faults.schedule(cfg, [
            faults.job_departs(0.2 * t, n_jobs - 1),
            faults.job_arrives(0.45 * t, n_jobs - 1),
            faults.link_flap(0.3 * t, 0.6 * t, 0, 0.5),
            faults.blackhole(0.1 * t, 0.35 * t, [0]),
            faults.straggle_burst(0.05 * t, 0.7 * t, 0.5)], spec=spec)
        ident = faults.identity_schedule(cfg, spec)
        overrides.update({f: np.stack([sched.values[f], ident.values[f]])
                          for f in sched.values})
    return cfg, overrides


# name -> (config, sweep overrides) of the armed kernel: each algorithm,
# OFF and WI, telemetry and faults together and apart, padded jobs
ARMED_CASES = {
    "reno_wi_both": _armed(),
    "reno_off_both": _armed(variant=0),
    "cubic_wi_both": _armed(algo=1, n_jobs=2),
    "dcqcn_wi_ecn_both": _armed(algo=2, spj=1, **RED_ECN),
    "reno_wi_telemetry_padded": _armed(
        tel=True, flt=False, detectors=("interleave", "iter_sketch"),
        job_active=[[True, True, False], [True, False, True]]),
    "dcqcn_off_faults": _armed(algo=2, variant=0, tel=False, **RED_ECN),
}


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):      # a TelemetryState's probe rings
        tree = list(tree.values())
    return [x for v in tree for x in _leaves(v)]


def _assert_bitwise(got, want):
    la, lb = _leaves(got), _leaves(want)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), \
            f"leaf {i} differs"


def _run(cfg, sweep, chunk):
    """run_ticks' loop with ``chunk`` as the chunk runner; returns the
    final state and the per-chunk probes."""
    statics = engine._build_statics(cfg, DEV)
    st = engine._init_state(cfg, statics, sweep)
    wl = engine._workload_view(cfg, statics, sweep)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    run = nc.prepare(cfg, statics, sweep, wl)
    probes = []
    for _ in range(cfg.n_ticks // tpc):
        inputs = engine.chunk_inputs(cfg, statics, sweep, st, tpc)
        st, pr = chunk(cfg, statics, sweep, wl, st, inputs, run)
        probes.append(pr)
    return st, probes


def _plain(cfg, statics, sweep, wl, st, inputs, run):
    return engine.run_chunk_reference(cfg, statics, sweep, wl, st, inputs)


# ---------------------------------------------------------------------------
# the kernel's body, built for the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the chunk "
                    "kernel's body for the CPU")
    return build_host_library(tmp_path_factory.mktemp("netsim_chunk"))



def _host_chunk(lib, threads):
    """One chunk through the host build, as `engine.run_chunk_reference`
    takes it: from an `EngineState` to the next one and the chunk's probes
    (from the kernel's epilogue)."""
    launch = host_launch(lib, threads)

    def chunk(cfg, statics, sweep, wl, st, inputs, run):
        cs = nc.pack_state(st)
        traces = nc.traces_for(cs, 1)
        launch(run, cs, inputs, traces, 0)
        return (nc.unpack_state(cs, inputs.key[-1], run.layout),
                tuple(t[:, 0] for t in traces))
    return chunk


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_body_equals_plain_version_bitwise(host_lib, case):
    cfg, overrides = CASES[case]
    sweep = netsim.make_sweep(cfg, device=DEV, **overrides)
    want = _run(cfg, sweep, _plain)
    threads = 1 if case == "two_tier" else 3
    got = _run(cfg, sweep, _host_chunk(host_lib, threads))
    _assert_bitwise(got, want)
    st = want[0]
    assert int(st.iter_idx.max()) >= 1       # iterations completed
    assert int(st.proto.det.n_boundaries.sum()) > 0


@pytest.mark.parametrize("case", sorted(ARMED_CASES))
def test_armed_kernel_body_equals_plain_version_bitwise(host_lib, case):
    """Telemetry and faults armed: the host build's chunks equal the
    per-tick path's on every leaf, the telemetry state's included."""
    cfg, overrides = ARMED_CASES[case]
    sweep = netsim.make_sweep(cfg, device=DEV, **overrides)
    want = _run(cfg, sweep, _plain)
    got = _run(cfg, sweep, _host_chunk(host_lib, 3))
    _assert_bitwise(got, want)
    st = want[0]
    assert int(st.iter_idx.max()) >= 1
    if cfg.telemetry is not None:
        tel = st.telemetry
        assert int(tel.n_samples.min()) > 0
        # every completed iteration is in the sketch
        assert torch.equal(tel.iter_hist.sum(-1), st.iter_idx)


def test_armed_packed_run_equals_per_tick_run(host_lib):
    """A whole armed run as run_ticks takes it on the card, the telemetry
    packed once with the state, against run_ticks' per-tick path."""
    cfg, overrides = ARMED_CASES["reno_wi_both"]
    sweep = netsim.make_sweep(cfg, device=DEV, **overrides)
    want = engine.run_ticks(cfg, sweep, per_tick=True)
    got = host_run_ticks(host_lib, cfg, sweep)
    _assert_bitwise(got, want)
    assert got.telemetry is not None


@pytest.mark.parametrize("case", ["reno_cassini_stragglers", "two_tier"])
def test_packed_run_equals_per_tick_run(host_lib, case):
    """A whole run as run_ticks takes it on the card: the state packed
    once (`ChunkRun`), one launch per chunk, the traces written by the
    kernel; against run_ticks' per-tick path on every RawSimOutput leaf."""
    cfg, overrides = CASES[case]
    sweep = netsim.make_sweep(cfg, device=DEV, **overrides)
    want = engine.run_ticks(cfg, sweep, per_tick=True)
    _assert_bitwise(host_run_ticks(host_lib, cfg, sweep), want)


def test_kernel_body_with_one_thread_per_cta(host_lib):
    """The same run with the CTA as one thread (every phase's split
    degenerate) and as more threads than the point has flows."""
    cfg, overrides = CASES["cubic_wi"]
    sweep = netsim.make_sweep(cfg, device=DEV, **overrides)
    one = _run(cfg, sweep, _host_chunk(host_lib, 1))
    many = _run(cfg, sweep, _host_chunk(host_lib, 7))
    _assert_bitwise(one, many)
    _assert_bitwise(one, _run(cfg, sweep, _plain))


def test_kernel_body_drops_and_marks(host_lib):
    """Runs whose queues pass RED's knee: Reno's losses and DCQCN's CNPs
    fire, and the kernel's draws match the plain version's."""
    for algo, red in ((0, {}), (2, RED_ECN)):
        cfg = _cfg(algo=algo, spj=2, sim_time=0.03, **red)
        cfg = dataclasses.replace(cfg, jobs=netsim.JobSpec.simple(
            [0.002] * 2, [2.5e7] * 2))
        sweep = netsim.make_sweep(cfg, device=DEV, seed=[1, 2])
        want = _run(cfg, sweep, _plain)
        _assert_bitwise(_run(cfg, sweep, _host_chunk(host_lib, 2)), want)
        traces = torch.stack([p[1] if algo == 0 else p[2]
                              for p in want[1]])
        assert float(traces.sum()) > 0


def test_kernel_body_matches_reference_trajectory(host_lib):
    """The kernel's logic against the JAX reference's simulator, with the
    Tier B / trace bounds of test_torch_engine."""
    ref = load_reference()
    rcore, rnet = ref["repro.core"], ref["repro.netsim"]
    rcfg = rnet.SimConfig(
        topo=rnet.dumbbell(2, sockets_per_job=2),
        jobs=rnet.JobSpec.simple([0.0075] * 2, [25e6] * 2),
        protocol=rcore.MLTCPConfig(cc=rcore.CCParams(
            algo=0, variant=1, tick_dt=DT, rtt=100e-6),
            slope=1.75, intercept=0.25),
        sim_time=0.05, dt=DT, seed=3)
    want = rnet.simulate(rcfg)
    cfg = _cfg(sim_time=0.05, jobs=netsim.JobSpec.simple([0.0075] * 2,
                                                        [25e6] * 2))
    cfg = dataclasses.replace(cfg, n_chunks=rcfg.n_chunks)
    st, probes = _run(cfg, netsim.make_sweep(cfg, device=DEV),
                      _host_chunk(host_lib, 2))
    traces = [torch.stack(c, dim=1)[0] for c in zip(*probes)]
    got = dict(zip(engine.CHUNK_FIELDS, traces))
    for name in ("trace_incomm", "trace_t"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(st.iter_idx[0].numpy(),
                                  np.asarray(want.iter_counts))
    np.testing.assert_array_equal(st.iter_times[0].numpy(),
                                  np.asarray(want.iter_times))
    for name in ("trace_util", "trace_drops", "trace_jobtput", "trace_ratio"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=0, err_msg=name)


@pytest.mark.parametrize("seeds,n_ticks,n_flows,n_jobs", [
    ([1, 2], 187, 4, 2), ([0, 7, 2**31 - 1], 50, 5, 3), ([3], 13, 12, 6)])
def test_host_draws_equal_numpy_draws(host_lib, seeds, n_ticks, n_flows,
                                      n_jobs):
    """The C draws the card's runs take (the library's host code) are
    `netsim.random.chunk_draws` bit for bit (test_torch_rng holds that
    against jax)."""
    key = rng.prng_key(np.asarray(seeds))
    want = rng.chunk_draws(key, n_ticks, n_flows, n_jobs)
    out = torch.empty((n_ticks, len(seeds), 2 * n_flows + 2 * n_jobs))
    keys = nc.host_draws(key, n_ticks, n_flows, n_jobs, out, lib=host_lib)
    np.testing.assert_array_equal(keys, want.keys)
    np.testing.assert_array_equal(
        out.numpy().view(np.uint32),
        np.concatenate((want.loss, want.cnp, want.strag, want.samt),
                       axis=-1).view(np.uint32))
    with pytest.raises(ValueError, match="contiguous float32"):
        nc.host_draws(key, n_ticks, n_flows, n_jobs, out[1:], lib=host_lib)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _mid_run(case="two_tier", ticks=300):
    cfg, overrides = CASES[case]
    cfg = dataclasses.replace(cfg, sim_time=ticks * DT, n_chunks=1)
    sweep = netsim.make_sweep(cfg, device=DEV, **overrides)
    raw = engine.run_ticks(cfg, sweep)
    return cfg, sweep, raw.final_state


def test_state_packing_round_trips_bitwise():
    _, _, st = _mid_run()
    cs = nc.pack_state(st)
    back = nc.unpack_state(cs, st.key)
    _assert_bitwise(back, st)
    assert all(x.is_contiguous() for x in _leaves(back)
               if isinstance(x, torch.Tensor))
    # fresh buffers: the kernel may update them in place
    ptrs = {x.untyped_storage().data_ptr() for x in _leaves(st)
            if isinstance(x, torch.Tensor)}
    assert not ptrs & {x.untyped_storage().data_ptr() for x in cs
                       if x is not None}


def test_run_and_input_operands_round_trip():
    cfg, sweep, st = _mid_run()
    statics = engine._build_statics(cfg, DEV)
    wl = engine._workload_view(cfg, statics, sweep)
    run = nc.prepare(cfg, statics, sweep, wl)
    shape = nc.shape_of(cfg)
    M, N, J, S = shape["M"], shape["N"], shape["J"], shape["S"]
    # the static blocks, cut at their documented boundaries
    ints = run.static_ints.split([N, N, J * S, J, (M + 1) * N])
    np.testing.assert_array_equal(ints[0], statics.groups.f2j)
    np.testing.assert_array_equal(ints[1], statics.last_link.reshape(-1))
    members = statics.groups.members.clone()
    members[members >= N] = -1
    np.testing.assert_array_equal(ints[2].view(J, S), members)
    np.testing.assert_array_equal(ints[3], statics.last_phase)
    np.testing.assert_array_equal(ints[4].view(M + 1, N), statics.prev_link)
    floats = run.static_floats.split([N, M, (M + 1) * N, (M + 1) * N, J])
    for got, want in zip(floats, (statics.spj_inv, statics.cap_dt,
                                  statics.first_hot,
                                  (~statics.is_final).float(),
                                  statics.flows_per_job)):
        _assert_bitwise(got.view(want.shape), want)
    for i, (_, name) in enumerate(nc.PARAM_FIELDS):
        want = getattr(sweep, name)
        if want is not None:
            _assert_bitwise(run.params[:, i], want)
    _assert_bitwise(run.job_tables[:, 0], sweep.compute)
    _assert_bitwise(run.job_tables[:, 1], sweep.comm_bytes)
    _assert_bitwise(run.flow_total, wl.flow_total)
    # a chunk's inputs: each operand points at its tensor, and the
    # uniforms read back through the row stride
    inputs = engine.chunk_inputs(cfg, statics, sweep, st, 17)
    cs = nc.pack_state(st)
    traces = nc.traces_for(cs, 3)
    operands, dims, scalars, _ = nc.launch_arguments(run, cs, inputs,
                                                     traces, 2)
    d = dict(zip(nc.DIMS, dims))
    assert (d["D_TICKS"], d["D_K"], d["D_N"], d["D_J"]) == (17, 2, N, J)
    assert (d["D_N_CHUNKS"], d["D_CHUNK"]) == (3, 2)
    with pytest.raises(ValueError, match="outside"):
        nc.launch_arguments(run, cs, inputs, traces, 3)
    ptr = dict(zip(nc.OPERANDS, operands))
    for name, t in (("O_T", inputs.t), ("O_STARTED", inputs.started),
                    ("O_STRAGGLES", inputs.straggles),
                    ("O_STRAG_AMT", inputs.strag_amt),
                    ("O_FFLOW", cs.fflow), ("O_ACC", cs.acc)):
        assert ptr[name] == t.data_ptr(), name
    for name in ("loss_u", "cnp_u"):
        u = getattr(inputs, name)
        assert ptr["O_" + name.upper()] == u.data_ptr()
        base = torch.as_strided(u, (17, 2, N),
                                (2 * d["D_U_STRIDE"], d["D_U_STRIDE"], 1))
        _assert_bitwise(base, u)
    for name, t in zip(nc.TRACE_OPERANDS, traces):
        assert ptr[name] == t.data_ptr(), name
    assert ptr["O_FACTORS"] is None and ptr["O_CASSINI"] is None
    # the unarmed run's detector constants are unread zeros
    np.testing.assert_array_equal(
        np.asarray(scalars, np.float32),
        np.asarray([cfg.dt, 1500.0, 750.0, cfg.buffer_bytes, 17.0,
                    17 * cfg.dt] + [0.0] * 6, np.float32))


# ---------------------------------------------------------------------------
# the source's enums are the wrapper's lists
# ---------------------------------------------------------------------------

def _enums(path: Path) -> dict:
    text = re.sub(r"//[^\n]*", "", path.read_text())
    return {name: [v.strip() for v in body.split(",") if v.strip()]
            for name, body in re.findall(r"enum\s+(\w+)\s*\{([^}]*)\}",
                                         text)}


def test_operand_lists_match_the_kernel_enums():
    enums = _enums(CSRC / "netsim_chunk.cu")
    for enum, names, count in (
            ("FFlow", nc.FLOW_FIELDS, "N_FFLOW"),
            ("IFlow", nc.IFLOW_FIELDS, "N_IFLOW"),
            ("Link", nc.LINK_FIELDS, "N_LINK"),
            ("RFlag", nc.RING_FLAG_FIELDS, "N_RFLAG"),
            ("FJob", nc.FJOB_FIELDS, "N_FJOB"),
            ("IJob", nc.IJOB_FIELDS, "N_IJOB"),
            ("Point", nc.POINT_FIELDS, "N_POINT"),
            ("Param", nc.PARAM_FIELDS, "N_PARAM")):
        assert enums[enum] == [n for n, _ in names] + [count], enum
    assert enums["TelI"] == [n for n, _ in nc.TEL_INT_FIELDS] + ["N_TELI"]
    assert enums["TelEv"] == [n for n, _ in nc.TEL_EV_FIELDS] + ["N_TELEV"]
    for _, field in nc.TEL_INT_FIELDS + nc.TEL_EV_FIELDS:
        assert field in telemetry.TelemetryState._fields, field
    assert [n for n in nc.DIMS if n.startswith("D_OFF_")] == [
        f"D_OFF_{p.upper()}" for p in telemetry.BUILTIN_PROBES]
    assert enums["Operand"] == list(nc.OPERANDS) + ["N_OPERAND"]
    assert enums["Dim"] == list(nc.DIMS) + ["N_DIM"]
    assert enums["Scalar"] == list(nc.SCALARS) + ["N_SCALAR"]
    assert len(enums["FX"]) - 1 == nc.N_FLOW_SCRATCH
    assert len(enums["IX"]) - 1 == nc.N_FLOW_ISCRATCH
    consts = _enums(CSRC / "mltcp_cc.cuh")["Const"]
    assert consts == ["C_" + f.upper() for f in ms.CONST_FIELDS] + ["N_CONST"]
    # every packed path names a leaf of EngineState
    _, _, st = _mid_run(ticks=3)
    for fields in (nc.FLOW_FIELDS, nc.IFLOW_FIELDS, nc.LINK_FIELDS,
                   nc.RING_FLAG_FIELDS, nc.FJOB_FIELDS, nc.IJOB_FIELDS,
                   nc.POINT_FIELDS):
        for _, path in fields:
            assert isinstance(nc._get(st, path), torch.Tensor), path


# ---------------------------------------------------------------------------
# budget and dispatch
# ---------------------------------------------------------------------------

# The largest fabric of each figure suite under benchmarks/ that builds
# one (job counts and sockets from the suite), and Fig. 6(b)'s leaf/spine.
SUITE_FABRICS = {
    "speedup_vs_jobs.py": (netsim.dumbbell(6, sockets_per_job=2), 6),
    "kernel_sweep.py": (netsim.dumbbell(3, sockets_per_job=2), 3),
    "convergence.py": (netsim.dumbbell(2, sockets_per_job=2), 2),
    "parameters.py": (netsim.dumbbell(3, sockets_per_job=2), 3),
    "partial_compat.py": (netsim.dumbbell(3, sockets_per_job=2), 3),
    "stragglers.py": (netsim.dumbbell(2, sockets_per_job=2), 2),
    "timeline.py": (netsim.dumbbell(2, sockets_per_job=2), 2),
    "churn.py": (netsim.dumbbell(3, sockets_per_job=2), 3),
    "circular.py": (netsim.triangle(sockets_per_job=2), 3),
    "two_tier": (netsim.two_tier([(0, 1), (1, 2), (2, 3), (3, 0)],
                                 sockets_per_job=2), 4),
}


def test_budget_admits_every_benchmark_fabric():
    calls = {p.name for p in (ROOT / "benchmarks").glob("*.py")
             if re.search(r"netsim\.(dumbbell|triangle|two_tier)\(",
                          p.read_text())}
    assert calls <= set(SUITE_FABRICS), calls - set(SUITE_FABRICS)
    p_max = max(len(p.compute_s) for p in workload.PAPER_MODELS.values())
    for name, (topo, n_jobs) in SUITE_FABRICS.items():
        profiles = [workload.profile_for("gpt3_hybrid")] * n_jobs
        cfg = _cfg(topo=topo, jobs=workload.jobspec_from_profiles(profiles))
        shape = nc.shape_of(cfg)
        assert shape["P"] == p_max and shape["D"] == 5
        assert nc.budget_reason(cfg) is None, name
        assert nc.smem_bytes(**shape) < 48 * 1024, name   # no opt-in needed
        assert ops.chunk_fallback_reason(
            cfg, netsim.make_sweep(cfg, device=DEV)) is None


def test_oversized_point_takes_the_counted_per_tick_path(monkeypatch):
    """A sweep the card would run (`ops.on_card` says so) whose point is
    over the budget takes the per-tick path, counted once per run and
    warned once."""
    pairs = [(i, i + 1) for i in range(40)]
    cfg = _cfg(topo=netsim.two_tier(pairs, n_leaves=100), n_jobs=40,
               sim_time=2 * DT, n_chunks=2)
    assert cfg.topo.n_links == 201
    reason = nc.budget_reason(cfg)
    assert reason is not None and "shared memory" in reason
    sweep = netsim.make_sweep(cfg, device=DEV)
    monkeypatch.setattr(ops, "on_card", lambda t: True)
    ops.reset_fallback_warnings()
    before = ops.CHUNK_FALLBACK_COUNT
    with pytest.warns(UserWarning, match="outside the chunk kernel") as rec:
        raw = engine.run_ticks(cfg, sweep)
        engine.run_ticks(cfg, sweep)
    assert len([w for w in rec if "chunk kernel" in str(w.message)]) == 1
    assert ops.CHUNK_FALLBACK_COUNT == before + 2        # once per run
    _assert_bitwise(raw, engine.run_ticks(cfg, sweep, per_tick=True))
    # a small fabric stays on the kernel's path
    small, _ = CASES["reno_wi"]
    assert ops.chunk_fallback_reason(
        small, netsim.make_sweep(small, device=DEV)) is None


def test_cc_fallback_configs_take_the_per_tick_path(monkeypatch):
    """A configuration the CC kernel does not take runs the per-tick path:
    on the CPU, where that path is the plain version, uncounted; on a sweep
    the card would run, counted once per run."""
    cfg = _cfg(proto=dict(favoritism="earliest_iter_start"), sim_time=4 * DT,
               n_chunks=2)
    sweep = netsim.make_sweep(cfg, device=DEV)
    assert ops.chunk_fallback_reason(cfg, sweep) == \
        "favoritism='earliest_iter_start'"
    before = ops.CHUNK_FALLBACK_COUNT
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        want = engine.run_ticks(cfg, sweep)
    assert ops.CHUNK_FALLBACK_COUNT == before
    assert not [w for w in rec if "chunk kernel" in str(w.message)]
    monkeypatch.setattr(ops, "on_card", lambda t: True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = engine.run_ticks(cfg, sweep)
    assert ops.CHUNK_FALLBACK_COUNT == before + 1
    _assert_bitwise(got, want)


def test_custom_probe_takes_the_counted_per_tick_path(monkeypatch):
    """A custom probe (a Python callable) runs the per-tick path on a sweep
    the card would run, counted once per run and warned once; the
    built-in probes on a built specialization do not."""
    name = "test_chunk_q_sq"
    telemetry.register_probe(name, "link", lambda s: s.q_len ** 2,
                             overwrite=True)
    base = _cfg(sim_time=4 * DT, n_chunks=2)
    custom = dataclasses.replace(base, telemetry=telemetry.TelemetrySpec(
        probes=(name, "link_queue"), stride=1, detectors=()))
    built = dataclasses.replace(base, telemetry=telemetry.TelemetrySpec())
    sweep = netsim.make_sweep(custom, device=DEV)
    assert "Python callable" in ops.chunk_fallback_reason(custom, sweep)
    assert ops.chunk_fallback_reason(
        built, netsim.make_sweep(built, device=DEV)) is None
    monkeypatch.setattr(ops, "on_card", lambda t: True)
    ops.reset_fallback_warnings()
    before = ops.CHUNK_FALLBACK_COUNT
    with pytest.warns(UserWarning, match="Python callable"):
        got = engine.run_ticks(custom, sweep)
    assert ops.CHUNK_FALLBACK_COUNT == before + 1
    _assert_bitwise(got, engine.run_ticks(custom, sweep, per_tick=True))
    series = got.telemetry.series
    assert torch.equal(series[name], series["link_queue"] ** 2)


@pytest.mark.parametrize("case", ["md", "per_flow_stats", "static_factors"])
def test_armed_unbuilt_specialization_raises_on_the_card(monkeypatch, case):
    """Built-in telemetry (or faults) armed on a CC specialization the
    armed kernel is not built for raises on a sweep the card would run,
    naming the specialization, and never takes the per-tick path; on the
    CPU it runs the plain version."""
    cfg = {"md": lambda: _cfg(variant=2, sim_time=4 * DT, n_chunks=2),
           "per_flow_stats": lambda: _cfg(
               proto=dict(aggregate_by_job=False), sim_time=4 * DT,
               n_chunks=2),
           "static_factors": lambda: _cfg(
               sim_time=4 * DT, n_chunks=2,
               static_job_factors=np.asarray([0.6, -1.0]))}[case]()
    cfg = dataclasses.replace(cfg, telemetry=telemetry.TelemetrySpec())
    sweep = netsim.make_sweep(cfg, device=DEV)
    want = engine.run_ticks(cfg, sweep)                  # the CPU: plain
    assert int(want.telemetry.n_samples.min()) > 0
    monkeypatch.setattr(ops, "on_card", lambda t: True)
    before = ops.CHUNK_FALLBACK_COUNT
    with pytest.raises(ValueError, match="not built for this CC "
                                         "specialization"):
        ops.chunk_fallback_reason(cfg, sweep)
    with pytest.raises(ValueError, match="armed chunk kernel"):
        engine.run_ticks(cfg, sweep)
    assert ops.CHUNK_FALLBACK_COUNT == before


def test_run_ticks_equals_the_per_tick_loop_on_cpu():
    """run_ticks on the CPU (each chunk through the plain version,
    `engine.run_chunk_reference`) equals the per-tick loop written out."""
    cfg, overrides = CASES["reno_cassini_stragglers"]
    sweep = netsim.make_sweep(cfg, device=DEV, **overrides)
    got = engine.run_ticks(cfg, sweep)
    statics = engine._build_statics(cfg, DEV)
    st = engine._init_state(cfg, statics, sweep)
    wl = engine._workload_view(cfg, statics, sweep)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    traces = []
    for _ in range(cfg.n_ticks // tpc):
        st = st._replace(acc_util=torch.zeros_like(st.acc_util),
                         acc_drops=torch.zeros_like(st.acc_drops),
                         acc_marks=torch.zeros_like(st.acc_marks),
                         acc_jobbytes=torch.zeros_like(st.acc_jobbytes))
        inputs = engine.chunk_inputs(cfg, statics, sweep, st, tpc)
        for i in range(tpc):
            st = engine._tick(cfg, statics, sweep, wl, st, inputs.at(i))
        traces.append(engine._chunk_probes(cfg, statics, st, tpc))
    stacked = [torch.stack(c, dim=1) for c in zip(*traces)]
    want = engine.RawSimOutput(
        iter_times=st.iter_times, iter_counts=st.iter_idx,
        **dict(zip(engine.CHUNK_FIELDS, stacked)), final_state=st)
    _assert_bitwise(got, want)
    _assert_bitwise(engine.run_ticks(cfg, sweep, per_tick=True), want)


def test_cpu_run_never_loads_a_kernel(monkeypatch):
    def refuse():
        raise AssertionError("a CPU run loaded a kernel library")
    for lib in (nc.LIBRARY, ms.LIBRARY):
        monkeypatch.setattr(lib, "load", refuse)
        monkeypatch.setattr(lib, "start_build", refuse)
    before = (nc.LAUNCH_COUNT, ms.LAUNCH_COUNT)
    cfg, overrides = CASES["dcqcn_wi_ecn"]
    cfg = dataclasses.replace(cfg, sim_time=50 * DT, n_chunks=5)
    raw = netsim.simulate_sweep(cfg, netsim.make_sweep(cfg, device=DEV,
                                                       **overrides),
                                device="cpu")
    assert int(raw.final_state.tick[0]) == 50
    assert (nc.LAUNCH_COUNT, ms.LAUNCH_COUNT) == before


def test_changing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    for f in CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    libs = []
    for name in ("netsim_chunk", "mltcp_step"):   # both share the header
        lib = build.KernelLibrary(name, lambda _: None)
        lib.source = tmp_path / f"{name}.cu"
        assert "mltcp_cc.cuh" in [p.name for p in
                                  build.local_includes(lib.source)]
        libs.append(lib)
    before = [lib.library_path() for lib in libs]
    assert [lib.library_path() for lib in libs] == before     # stable
    header = tmp_path / "mltcp_cc.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = [lib.library_path() for lib in libs]
    assert all(a != b for a, b in zip(after, before))
    assert all(p.name.startswith(lib.name + "_")
               for p, lib in zip(after, libs))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_chunk_kernel_equals_per_tick_path_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs this comparison on the card)")
    dev = torch.device("cuda")
    for case in ("reno_wi", "dcqcn_wi_ecn", "two_tier"):
        cfg, overrides = CASES[case]
        sweep = netsim.make_sweep(cfg, device=dev, **overrides)
        before = nc.LAUNCH_COUNT
        got = engine.run_ticks(cfg, sweep)
        assert nc.LAUNCH_COUNT - before == cfg.n_chunks
        want = engine.run_ticks(cfg, sweep, per_tick=True)
        _assert_bitwise(_np_tree(got), _np_tree(want))


def _np_tree(tree):
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
            for x in _leaves(tree)]
