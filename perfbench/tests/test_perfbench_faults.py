"""The comparison that decides ``correct`` fails a broken program and its
control: a run on the CPU (past the look for a card) with the timed path
broken underneath sees ``correct`` come out false, once for each fault the
simulator's cells can have, and the reference in bfloat16 in the
program's place reads every judged point as differing."""
import numpy as np
import pytest
import torch
from conftest import cpu_run, tiny_cell

from repro_torch.netsim import engine, experiment


@pytest.mark.parametrize("name", ["fig10-reno.seeds3", "fig10-dcqcn.seeds3"])
def test_sound_run_is_correct(name):
    r = cpu_run(tiny_cell(name))
    assert r["correct"] is True
    assert r["checks"]["diverged_pct"]["value"] == 0.0


def _chunk_fault(kind):
    original = engine.run_chunk_reference

    def broken(cfg, statics, sweep, wl, st, inputs):
        if kind == "state_unchanged":
            # the step returns the state it was given
            return st, engine._chunk_probes(cfg, statics, st,
                                            int(inputs.t.shape[0]))
        st2, probes = original(cfg, statics, sweep, wl, st, inputs)
        if kind == "answer_altered":
            # one point's utilization, one chunk, a last bit off
            util = probes[0].clone()
            util[0] = torch.nextafter(util[0], util[0] + 1.0)
            probes = (util,) + tuple(probes[1:])
        return st2, probes

    return broken


def _half_batch(sim):
    def broken(cfg, sweep, device=None):
        k = engine.sweep_len(sweep)
        half = engine.SweepParams(*[None if v is None else v[:k // 2]
                                    for v in sweep])
        raw = sim(cfg, half, device=device)

        def fill(x):
            if not isinstance(x, torch.Tensor) or x.ndim == 0:
                return x
            rest = x.float().mean(0, keepdim=True).to(x.dtype)
            return torch.cat([x, rest.expand((k - k // 2,) + x.shape[1:])])

        return engine.tree_map(fill, raw)

    return broken


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    if fault == "half_batch":
        monkeypatch.setattr(experiment, "simulate_sweep",
                            _half_batch(experiment.simulate_sweep))
    else:
        monkeypatch.setattr(engine, "run_chunk_reference",
                            _chunk_fault(fault))
    r = cpu_run(tiny_cell("fig10-reno.seeds3"))
    assert r["correct"] is False
    assert r["checks"]["diverged_pct"]["value"] > 0.0


@pytest.mark.parametrize("name", ["fig10-reno.seeds3", "fig10-dcqcn.seeds3"])
def test_control_in_bfloat16_is_not_correct(name):
    from reference import control

    out = control.control(tiny_cell(name, sim_time=0.02, n_chunks=4),
                          seed=3_000_000_201, worker=False)
    assert out["correct"] is False
    assert out["numbers"]["diverged_pct"]["value"] == 100.0


def test_bf16_rounds_to_nearest_even():
    from reference import fluid

    # bfloat16 keeps 7 bits after the point: ties go to the even one
    x = np.asarray([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9,
                    1.0 + 3 * 2 ** -9, -2.5, 0.0], np.float32)
    want = np.asarray([1.0, 1.0, 1.0 + 2 ** -6, 1.0, 1.0 + 2 ** -7, -2.5,
                       0.0], np.float32)
    np.testing.assert_array_equal(fluid.bf16(x), want)
