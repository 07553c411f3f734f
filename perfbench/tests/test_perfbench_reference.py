"""The plain reference against the port's per-tick path on the CPU: the
same bits on every judged field, on both configurations, at a few
thousand ticks and a small plan; and its draws against the port's."""
import copy

import numpy as np
import pytest
from conftest import bench_json

from harness import registry
from reference import fluid, judge, rng


def _small(name, sim_time=0.12):
    cell = registry.load_cell(bench_json(), name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(sim_time=sim_time, n_chunks=10)
    cfg["axes"] = {"variant": ["OFF", "WI"], "n_jobs": [2, 6]}
    return cell, cfg


@pytest.mark.parametrize("name", ["fig10-reno.seeds3", "fig10-dcqcn.seeds3"])
def test_reference_equals_port_cpu(name):
    from repro_torch import netsim

    cell, cfg = _small(name)
    drv = registry.load_module(cell.driver_path, "driver_netsim_plan")
    seeds = [5, 2_147_000_001]
    capture = drv.Capture()
    try:
        pr = netsim.run_plan(drv.build_plan(cfg, seeds), device="cpu")
        raws = capture.take()
    finally:
        capture.close()
    points = drv.plan_points(cfg, seeds)
    ref = fluid.simulate(cfg, points, worker=False)
    iterations = events = 0
    for i, (res, (point, raw)) in enumerate(zip(pr.results, raws)):
        assert point.axes == points[i] == res.point.axes
        n = points[i]["n_jobs"]
        got = judge.compare_point(judge.program_view(res, raw, n),
                                  fluid.postprocess(ref, i, n))
        assert got["diff"] is None, (points[i], got)
        iterations += sum(len(x) for x in res.iter_times)
        events += res.drops_per_s + res.marks_per_s
    # the comparison saw iterations end and RED act
    assert iterations > 0 and events > 0


def test_draws_equal_the_ports():
    from repro_torch.netsim import random as port_rng

    seeds = [0, 1, 2_147_483_647, 3_000_000_001]
    key = rng.seed_keys(seeds)
    np.testing.assert_array_equal(key, port_rng.prng_key(np.asarray(seeds)))
    mine = rng.chunk_uniforms(key, 40, 12, 6)
    theirs = port_rng.chunk_draws(key, 40, 12, 6)
    for a, b in zip(mine, (theirs.keys[-1], theirs.loss, theirs.cnp,
                           theirs.strag, theirs.samt)):
        np.testing.assert_array_equal(a, b)


def test_draw_worker_gives_the_same_run():
    _, cfg = _small("fig10-dcqcn.seeds3", sim_time=0.004)
    points = [{"variant": "WI", "n_jobs": 3, "seed": 9}]
    a = fluid.simulate(cfg, points, worker=True)
    b = fluid.simulate(cfg, points, worker=False)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_ambiguous_draw_marks_its_point():
    _, cfg = _small("fig10-reno.seeds3")
    sim = fluid.FluidSim(cfg, [{"variant": "OFF", "n_jobs": 2, "seed": 1},
                               {"variant": "WI", "n_jobs": 2, "seed": 2}])
    p = np.full((2, sim.fab.N), 0.3, np.float32)
    u = p.copy()
    u[0] = 0.7
    u[1, 3] = np.nextafter(np.float32(0.3), np.float32(1))
    sim.tick = 17
    sim._note_ambiguous(u, p)
    assert list(sim.first_ambiguous) == [sim.n_ticks, 17]


def test_comparison_stops_at_the_first_ambiguous_chunk():
    _, cfg = _small("fig10-reno.seeds3", sim_time=0.004)
    point = {"variant": "WI", "n_jobs": 2, "seed": 4}
    ref = fluid.postprocess(fluid.simulate(cfg, [point], worker=False), 0, 2)
    prog = {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in ref.items()}
    prog["trace_util"][-1] += 1.0
    prog["result_traces"] = {k: prog[k] for k in judge.RESULT_TRACES}
    assert judge.compare_point(prog, ref)["diff"] == "trace_util"
    tpc = ref["ticks_per_chunk"]
    ref["first_ambiguous"] = (ref["trace_t"].shape[0] - 1) * tpc
    assert judge.compare_point(prog, ref)["diff"] is None
