"""The port's telemetry (`repro_torch.netsim.telemetry`) against the JAX
reference's, and the reference's own properties on the port.

* Tier A: `tick_update` on fuzzed `TickSignals`, K points a tick for 48
  ticks, against the reference's `tick_update` point by point: ints,
  bools, the ring's sample ticks and the histogram exactly; the EWMAs and
  the overlap within ``EWMA_ULP``.  `collect` on a state
  carried across from the reference equals the reference's `collect`.
* On the port (tests/test_telemetry.py's properties): telemetry off is
  bitwise and adds no leaf, arming changes no other leaf; a decimated ring
  is the dense ring's restriction; a ring that wraps keeps the latest
  samples in order; the interleave detector equals a numpy replay; the
  sketch's quantiles are within a bin of ``np.quantile``; a padded group
  trims each point's series; an unknown probe is rejected and a custom
  one captured; the accessors.
* Tier B: a 0.3 s Reno WI run (and MD, BOTH, per-flow statistics, Static
  factors) with every built-in probe and both detectors through the port (the chunk kernel's body built for the CPU,
  `_torch_host_chunk`: the per-tick path costs ~3 ms a tick on the CPU) and
  the reference: sample ticks, iteration counts, the histogram and the
  last bad tick exactly; the series within ``SERIES_RTOL`` of the largest
  magnitude of each.  The re-interleave detector on a faulted run: the
  per-event arrays exactly.
"""
import dataclasses
import math

import numpy as np
import pytest

from _torch_host_chunk import build_host_library, compiler, host_run_ticks
from _torch_reference import assert_ulp, load_reference, reference_modules

import torch

from repro_torch import core as tcore
from repro_torch import netsim as tnet
from repro_torch.kernels import ops
from repro_torch.netsim import convert, engine, metrics
from repro_torch.netsim import telemetry as ttel

REF = load_reference()
rcore = REF["repro.core"]
rnet = REF["repro.netsim"]
SIDES = {"ref": (rcore, rnet), "port": (tcore, tnet)}
DT = 2e-5
DEV = "cpu"
ALL_PROBES = ttel.BUILTIN_PROBES
# Tier A: the pair EWMAs and the overlap, port against reference: XLA may
# contract the EWMA step ``e + a * (x - e)`` into a fused multiply-add,
# torch does not (measured 0 ulp on the CPU)
EWMA_ULP = 2
# Tier B: each probe's series, port against reference, relative to the
# series' largest magnitude (iteration counts equal, so the runs differ by
# operation order only; measured 1.5e-6 on the CPU, link_mark_rate)
SERIES_RTOL = 1e-5


def _cfg(side, n_jobs=2, sim_time=0.02, algo=0, variant=1, compute=0.002,
         comm=2e6, seed=3, proto=None, **kw):
    core, net = SIDES[side]
    red = (dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2) if algo == 2
           else {})
    return net.SimConfig(
        topo=net.dumbbell(n_jobs, sockets_per_job=2),
        jobs=net.JobSpec.simple([compute] * n_jobs, [comm] * n_jobs),
        protocol=core.MLTCPConfig(cc=core.CCParams(
            algo=algo, variant=variant, tick_dt=DT, rtt=100e-6),
            slope=1.75, intercept=0.25, **(proto or {})),
        sim_time=sim_time, dt=DT, seed=seed, **{**red, **kw})


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the chunk "
                    "kernel's body for the CPU")
    return build_host_library(tmp_path_factory.mktemp("netsim_chunk"))


def _np(tree):
    return engine.tree_map(lambda x: x.numpy(), tree)


# ---------------------------------------------------------------------------
# Tier A: tick_update and collect
# ---------------------------------------------------------------------------

def _fuzz_signals(rng, k, n, m, j, e, tick):
    """One tick's signals for K points, as numpy."""
    def f32(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (k,) + shape).astype(np.float32)
    return dict(
        tick=np.full((k,), tick, np.int32),
        t=np.full((k,), np.float32(tick * DT)),
        cwnd=f32(n, lo=1, hi=500), rate=f32(n, lo=1e6, hi=6e9),
        bytes_ratio=f32(n), q_len=f32(m, hi=2e6), red_prob=f32(m),
        in_comm=rng.uniform(size=(k, j)) < 0.5,
        phase_idx=rng.integers(0, 3, (k, j)).astype(np.int32),
        iter_idx=rng.integers(0, 50, (k, j)).astype(np.int32),
        iter_done=rng.uniform(size=(k, j)) < 0.4,
        # log-uniform over [1e-6, 1e3] s: past both ends of the sketch
        iter_time=np.exp(rng.uniform(np.log(1e-6), np.log(1e3),
                                     (k, j))).astype(np.float32),
        f_job=f32(j, lo=0.25, hi=2.0),
        job_active=rng.uniform(size=(k, j)) < 0.8,
        fault_idx=rng.integers(0, e, (k,)).astype(np.int32))


def test_tick_update_matches_reference_on_fuzzed_signals():
    """K=4 points, 3 jobs (3 pairs), every probe and detector, a ring of 5
    slots at stride 3 (it wraps), ticks across the tail boundary."""
    k, e = 4, 5
    specs, cfgs = {}, {}
    for side in ("ref", "port"):
        _, net = SIDES[side]
        specs[side] = net.TelemetrySpec(probes=ALL_PROBES, stride=3,
                                        capacity=5, detectors=(
                                            "interleave", "iter_sketch",
                                            "reinterleave"),
                                        overlap_threshold=0.3)
        cfgs[side] = _cfg(side, n_jobs=3, sim_time=100 * DT,
                          telemetry=specs[side],
                          faults=net.FaultSpec(n_events=e, churn=True))
    cfg = cfgs["port"]
    n, m, j = cfg.topo.n_flows, cfg.topo.n_links, cfg.jobs.n_jobs
    with reference_modules():
        import jax.numpy as jnp
        from repro.netsim import telemetry as rtel
        ref_states = [rtel.init_state(cfgs["ref"], specs["ref"])
                      for _ in range(k)]
    st = ttel.init_state(cfg, specs["port"], k, DEV)
    rng = np.random.default_rng(5)
    for tick in range(cfg.n_ticks // 2 - 24, cfg.n_ticks // 2 + 24):
        sig = _fuzz_signals(rng, k, n, m, j, e, tick)
        st = ttel.tick_update(cfg, specs["port"], st, ttel.TickSignals(
            **{f: torch.as_tensor(v) for f, v in sig.items()}))
        with reference_modules():
            ref_states = [rtel.tick_update(
                cfgs["ref"], specs["ref"], ref_states[p],
                rtel.TickSignals(**{f: jnp.asarray(v[p])
                                    for f, v in sig.items()}))
                for p in range(k)]
    for field in ttel.TelemetryState._fields:
        got = getattr(st, field)
        want = [getattr(r, field) for r in ref_states]
        if field == "series":
            for name in ALL_PROBES:
                w = np.stack([np.asarray(x[name]) for x in want])
                g = got[name].numpy()
                if name == "interleave_overlap":
                    assert_ulp(g, w, EWMA_ULP, name)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        w = np.stack([np.asarray(x) for x in want])
        if field in ("ewma_both", "ewma_either"):
            assert_ulp(got.numpy(), w, EWMA_ULP, field)
        else:
            assert got.dtype == torch.int32, field
            np.testing.assert_array_equal(got.numpy(), w, err_msg=field)
    assert int(st.iter_hist.sum()) > 0 and int(st.tail_bad.sum()) > 0


def _ref_telemetry_run(sim_time=0.04, **kw):
    """A reference run with every probe and both detectors."""
    rspec = rnet.TelemetrySpec(probes=ALL_PROBES, stride=11, **kw)
    rcfg = _cfg("ref", telemetry=rspec, sim_time=sim_time)
    return rcfg, rnet.simulate(rcfg)


def test_collect_on_a_carried_state_equals_the_reference():
    rcfg, raw = _ref_telemetry_run()
    want = rnet.postprocess(rcfg, raw).telemetry
    import jax
    state = convert.telemetry_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, raw.telemetry), batched=False,
        device=DEV)
    cfg = _cfg("port", sim_time=rcfg.sim_time, telemetry=ttel.TelemetrySpec(
        probes=ALL_PROBES, stride=11))
    got = ttel.collect(cfg, engine.point_of(state, 0))
    for f in dataclasses.fields(want):
        if f.name == "spec":
            continue
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, dict):
            assert list(g) == list(w)
            for name in w:
                np.testing.assert_array_equal(g[name], w[name])
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w or (g != g and w != w), f.name
    assert got.p50_iter == want.p50_iter


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------

def _flat(tree):
    if isinstance(tree, np.ndarray):
        tree = torch.as_tensor(tree.view(np.int32))
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [x for v in tree for x in _flat(v)]


def _equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("algo", [0, 1, 2])
def test_off_is_bitwise_and_arming_changes_nothing(algo):
    cfg = _cfg("port", algo=algo, sim_time=0.01)
    off = tnet.simulate(cfg, device=DEV)
    assert off.telemetry is None and off.final_state.telemetry is None
    # iter_times, iter_counts and the seven chunk probes: no other leaf
    assert len(_flat(off._replace(final_state=None))) == \
        2 + len(ttel.CHUNK_PROBES)
    on = tnet.simulate(dataclasses.replace(cfg, telemetry=ttel.TelemetrySpec(
        probes=ALL_PROBES, stride=40)), device=DEV)
    assert on.telemetry is not None
    for f in engine.RawSimOutput._fields:
        if f not in ("final_state", "telemetry"):
            assert _equal(getattr(on, f), getattr(off, f)), f
    for x, y in zip(_flat(on.final_state._replace(telemetry=None)),
                    _flat(off.final_state)):
        assert _equal(x, y)


def test_decimated_ring_is_the_dense_restriction_and_wraps():
    probes = ("flow_cwnd", "link_queue", "job_incomm", "job_f")
    base = _cfg("port", sim_time=0.01)
    runs = {}
    for name, spec in (("dense", ttel.TelemetrySpec(probes=probes, stride=1,
                                                    detectors=())),
                       ("dec", ttel.TelemetrySpec(probes=probes, stride=37,
                                                  detectors=())),
                       ("wrap", ttel.TelemetrySpec(probes=probes, stride=10,
                                                   capacity=13,
                                                   detectors=()))):
        cfg = dataclasses.replace(base, telemetry=spec)
        runs[name] = (cfg, ttel.collect(cfg, tnet.simulate(
            cfg, device=DEV).telemetry))
    dense, dec, wrap = (runs[n][1] for n in ("dense", "dec", "wrap"))
    assert np.array_equal(dec.ticks, dense.ticks[::37])
    for name in probes:
        assert np.array_equal(dec.series[name], dense.series[name][::37])
    sampled = np.arange(0, base.n_ticks, 10)
    assert np.array_equal(wrap.ticks, sampled[-13:])
    assert wrap.n_samples == len(sampled)
    for name in probes:
        assert np.array_equal(wrap.series[name],
                              dense.series[name][sampled[-13:]])


def test_interleave_detector_matches_numpy_replay():
    spec = ttel.TelemetrySpec(probes=("job_incomm", "job_iter"), stride=1)
    cfg = _cfg("port", sim_time=0.03, telemetry=spec)
    raw = tnet.simulate(cfg, device=DEV)
    ic = raw.telemetry.series["job_incomm"].numpy() > 0.5
    ji = raw.telemetry.series["job_iter"].numpy()
    alpha = np.float32(-math.expm1(-cfg.dt / spec.overlap_tau))
    a, b = ic[:, 0], ic[:, 1]
    eb = ee = np.float32(0.0)
    last_bad, iters_at = -1, 0
    for t in range(len(a)):
        eb = eb + alpha * (np.float32(a[t] & b[t]) - eb)
        ee = ee + alpha * (np.float32(a[t] | b[t]) - ee)
        ov = eb / max(ee, np.float32(1e-6))
        if ov > spec.overlap_threshold:
            last_bad, iters_at = t, ji[t].max()
    assert int(raw.telemetry.last_bad_tick) == last_bad >= 0
    assert int(raw.telemetry.iters_at_last_bad) == int(iters_at)
    res = ttel.collect(cfg, raw.telemetry)
    hold = int(round(spec.hold_frac * cfg.n_ticks))
    assert res.converged == (last_bad < cfg.n_ticks - hold)


def test_iter_sketch_quantiles_match_percentile():
    spec = ttel.TelemetrySpec(probes=(), detectors=("iter_sketch",))
    cfg = _cfg("port", sim_time=0.06, telemetry=spec)
    res = tnet.postprocess(cfg, tnet.simulate(cfg, device=DEV))
    exact = np.concatenate(res.iter_times)
    assert int(res.telemetry.iter_hist.sum()) == exact.size > 20
    bin_w = (spec.sketch_hi / spec.sketch_lo) ** (1.0 / spec.sketch_bins)
    for q in (0.5, 0.99):
        sk = tnet.iter_time_quantile(res, q)
        ex = float(np.quantile(exact, q))
        assert ex / bin_w <= sk <= ex * bin_w


def test_padded_group_trims_point_telemetry():
    spec = ttel.TelemetrySpec(probes=("flow_cwnd", "job_incomm"), stride=50)

    def build(pt):
        return _cfg("port", n_jobs=pt["n_jobs"], sim_time=0.01)
    plan = tnet.Plan(name="tele-pad", axes=(tnet.Axis("n_jobs", (2, 3)),),
                     build=build)
    pr = tnet.run_plan(plan, telemetry=spec, device=DEV)
    assert pr.n_compile_groups == 1
    for r in pr:
        n = r.point["n_jobs"]
        assert r.telemetry.series["job_incomm"].shape[1] == n
        assert r.telemetry.series["flow_cwnd"].shape[1] == 2 * n
        assert r.telemetry.iter_hist.shape[0] == n


def test_unknown_probe_rejected_and_custom_probe_captured():
    cfg = dataclasses.replace(_cfg("port", sim_time=0.004),
                              telemetry=ttel.TelemetrySpec(
                                  probes=("no_such",)))
    with pytest.raises(ValueError, match="no_such"):
        tnet.simulate(cfg, device=DEV)
    name = "test_telemetry_q_sq"
    tnet.register_probe(name, "link", lambda s: s.q_len ** 2, overwrite=True)
    with pytest.raises(ValueError, match="already registered"):
        tnet.register_probe(name, "link", lambda s: s.q_len)
    with pytest.raises(ValueError, match="unknown kind"):
        tnet.register_probe("bad_kind", "pair", lambda s: s.q_len)
    assert not ttel.is_builtin(name) and ttel.is_builtin("link_queue")
    spec = ttel.TelemetrySpec(probes=(name, "link_queue"), stride=25,
                              detectors=())
    cfg = dataclasses.replace(_cfg("port", sim_time=0.01), telemetry=spec)
    res = ttel.collect(cfg, tnet.simulate(cfg, device=DEV).telemetry)
    assert np.array_equal(res.series[name], res.series["link_queue"] ** 2)
    # the card would take the per-tick path for it (counted there;
    # tests/test_torch_chunk.py runs that path)
    assert "Python callable" in ops.chunk_fallback_reason(
        cfg, tnet.make_sweep(cfg, device=DEV))
    with pytest.raises(ValueError, match="unknown detector"):
        ttel.TelemetrySpec(detectors=("nope",))
    with pytest.raises(ValueError, match="stride"):
        ttel.TelemetrySpec(stride=0)
    with pytest.raises(ValueError, match="needs cfg.faults"):
        tnet.simulate(dataclasses.replace(cfg, telemetry=ttel.TelemetrySpec(
            detectors=("reinterleave",))), device=DEV)
    with pytest.raises(TypeError, match="TelemetrySpec"):
        tnet.simulate(dataclasses.replace(cfg, telemetry=object()),
                      device=DEV)


def test_probe_timeline_accessors():
    spec = ttel.TelemetrySpec(stride=50)
    cfg = dataclasses.replace(_cfg("port", sim_time=0.01), telemetry=spec)
    res = tnet.postprocess(cfg, tnet.simulate(cfg, device=DEV))
    t, cw = tnet.probe_timeline(res, "flow_cwnd")
    assert t.shape[0] == cw.shape[0] == 10 and cw.shape[1] == 4
    assert metrics.time_to_interleave(res) >= 0.0
    assert tnet.convergence_iteration(res) >= 0.0
    with pytest.raises(KeyError, match="job_f"):
        tnet.probe_timeline(res, "job_f")
    off = tnet.postprocess(_cfg("port", sim_time=0.004),
                           tnet.simulate(_cfg("port", sim_time=0.004),
                                         device=DEV))
    with pytest.raises(ValueError, match="telemetry"):
        tnet.time_to_interleave(off)


# ---------------------------------------------------------------------------
# Tier B: whole runs, port (the kernel's body on the CPU) and reference
# ---------------------------------------------------------------------------

def _port_run(host_lib, cfg):
    raw = host_run_ticks(host_lib, cfg, tnet.make_sweep(cfg, device=DEV))
    return engine.point_of(raw, 0)


def _armed_trajectory_matches_reference(host_lib, **cc_kw):
    """A 0.3 s run with every built-in probe and both detectors armed (the
    CC specialization from ``cc_kw``) through the port and the reference:
    the sample ticks, iteration counts and detector integers exactly, each
    series within ``SERIES_RTOL`` of its largest magnitude."""
    kw = dict(sim_time=0.3, compute=0.0075, comm=25e6, **cc_kw)
    rspec = rnet.TelemetrySpec(probes=ALL_PROBES, stride=50)
    rcfg = _cfg("ref", telemetry=rspec, **kw)
    want = rnet.simulate(rcfg)
    cfg = _cfg("port", telemetry=ttel.TelemetrySpec(probes=ALL_PROBES,
                                                    stride=50), **kw)
    got = _port_run(host_lib, cfg)
    np.testing.assert_array_equal(got.iter_counts.numpy(),
                                  np.asarray(want.iter_counts))
    assert int(got.iter_counts.min()) >= 10
    wt, gt = want.telemetry, got.telemetry
    np.testing.assert_array_equal(gt.sample_tick.numpy(),
                                  np.asarray(wt.sample_tick))
    for field in ("iter_hist", "last_bad_tick", "iters_at_last_bad",
                  "tail_bad", "tail_ticks", "n_samples"):
        np.testing.assert_array_equal(getattr(gt, field).numpy(),
                                      np.asarray(getattr(wt, field)),
                                      err_msg=field)
    for name in ALL_PROBES:
        w = np.asarray(wt.series[name], np.float64)
        g = gt.series[name].numpy().astype(np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= SERIES_RTOL * scale, name


def test_armed_trajectory_matches_reference(host_lib):
    _armed_trajectory_matches_reference(host_lib)


# the CC specializations the armed kernel takes as launch dims, beside
# Reno WI with job statistics: MD, BOTH, per-flow statistics, and Static
# factors beside the adaptive sentinel
ARMED_SELECTIONS = {
    "md": dict(variant=2),
    "both": dict(variant=3),
    "per_flow_stats": dict(proto=dict(aggregate_by_job=False)),
    "static_factors": dict(static_job_factors=np.asarray([0.6, -1.0])),
}


@pytest.mark.parametrize("case", sorted(ARMED_SELECTIONS))
def test_armed_trajectory_matches_reference_on_specialization(host_lib,
                                                              case):
    _armed_trajectory_matches_reference(host_lib,
                                        **ARMED_SELECTIONS[case])


def test_reinterleave_detector_matches_reference(host_lib):
    """A churned job leaves and returns: the per-event arrays equal the
    reference's, and every observed window has a report."""
    out = {}
    for side in ("ref", "port"):
        _, net = SIDES[side]
        spec = net.TelemetrySpec(
            probes=("interleave_overlap", "job_iter"), stride=8,
            detectors=("interleave", "iter_sketch", "reinterleave"))
        faults = net.FaultSpec(n_events=5, churn=True, link_flaps=True)
        cfg = _cfg(side, sim_time=0.12, compute=0.004, comm=10e6,
                   telemetry=spec, faults=faults)
        sched = net.fault_schedule(cfg, [
            net.job_departs(0.03, 1), net.job_arrives(0.06, 1),
            net.link_flap(0.08, 0.1, 0, 0.5)], spec=faults)
        if side == "ref":
            raw = net.simulate_sweep(cfg, net.make_sweep(
                cfg, **sched.overrides()))
            import jax
            raw = jax.tree_util.tree_map(lambda x: x[0], raw)
            counts = np.asarray(raw.iter_counts)
        else:
            raw = engine.point_of(host_run_ticks(host_lib, cfg, net.make_sweep(
                cfg, device=DEV, **sched.overrides())), 0)
            counts = raw.iter_counts.numpy()
        out[side] = (cfg, raw, counts, sched)
    np.testing.assert_array_equal(out["port"][2], out["ref"][2])
    for field in ("ev_start_tick", "ev_start_iter", "ev_end_tick",
                  "ev_last_bad_tick", "ev_iters_at_last_bad"):
        np.testing.assert_array_equal(
            getattr(out["port"][1].telemetry, field).numpy(),
            np.asarray(getattr(out["ref"][1].telemetry, field)),
            err_msg=field)
    cfg, raw, _, sched = out["port"]
    res = tnet.postprocess(cfg, raw).telemetry
    assert [r.start_tick for r in res.fault_events] == \
        list(sched.values["fault_tick"])
