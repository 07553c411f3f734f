"""The four example scripts on the port (`repro_torch.examples`) against
the JAX reference's ``examples/`` scripts, on the CPU at small sizes.

* ``interleave_demo`` at 0.3 s and ``simulate_cluster`` at 0.3 s take the
  card's route: each chunk is one launch of the chunk kernel (its body
  built for the CPU, ``_torch_host_chunk``; the armed kernel for the
  demo's probes), counted as on the card, with no fallback.  The
  reference's script runs at the same simulated time (its module's
  ``SIM_TIME`` and ``SPEC``, or the time it hands
  ``simulate_shared_cluster``, patched), the cluster on the reference's
  TPU constants on both sides.  The two print the same lines in the same
  order: the same text once the numbers are taken out, each number within
  ``test_torch_cluster``'s Tier B bounds (2% relative, 0.02 absolute), and
  each ASCII timeline within one shade a column.
* ``quickstart`` trains a few steps: finite losses, its own assertion that
  the loss dropped, and the checkpoint written to ``--ckpt-dir``.
* ``serve_lm`` is the serving launcher at the smoke preset: its ids are
  `launch.serve.serve`'s for the same request.  Its weights are random
  from the seed in each package, so no number of it can be held against
  the reference's; ``test_torch_serve`` and ``test_torch_models`` hold the
  serving path itself against the reference.
"""
import dataclasses
import functools
import importlib.util
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_host_chunk import build_host_library, compiler, host_launch
from _torch_reference import load_reference, reference_modules

import torch

from repro_torch import cluster
from repro_torch.checkpoint import CheckpointManager
from repro_torch.examples import (interleave_demo, quickstart, serve_lm,
                                  simulate_cluster)
from repro_torch.kernels import netsim_chunk as nc
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.roofline import HwSpec

ROOT = Path(__file__).resolve().parents[1]
SIM_TIME = 0.3
# test_torch_cluster's Tier B bounds
RTOL = ATOL = 0.02
SHADES = " .:-=+*#%@"
NUMBER = re.compile(r"(?<![\w.])[-+]?(?:\d+\.?\d*|\.\d+)(?![\w.])|\bnan\b"
                    r"|\binf\b")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a host C++ compiler (g++) to build the chunk "
                    "kernel's body for the CPU")
    return build_host_library(tmp_path_factory.mktemp("netsim_chunk"))


@pytest.fixture
def card_route(host_lib, monkeypatch):
    """The card's route on the CPU: `ops.netsim_chunk` takes the chunk
    kernel, and each launch runs its body built for the CPU and counts as
    `netsim_chunk.launch` does."""
    launch = host_launch(host_lib, 2)

    def counted(*args):
        launch(*args)
        nc.LAUNCH_COUNT += 1
    monkeypatch.setattr(ops, "on_card", lambda t: True)
    monkeypatch.setattr(nc, "launch", counted)


def _reference_script(name):
    """``examples/<name>.py`` of the reference as a module, loaded with the
    reference's modules in place (call its ``main`` inside
    `reference_modules` too)."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        with reference_modules():
            spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def _assert_same_lines(got: str, want: str):
    """The port's printed lines against the reference's: the same lines in
    the same order; a timeline (``|...|``) within one shade a column;
    every other line the same text with its numbers within the bounds."""
    got, want = got.strip().splitlines(), want.strip().splitlines()
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if g.count("|") == 2 and w.count("|") == 2:
            (gl, gs, gr), (wl, ws, wr) = g.split("|"), w.split("|")
            assert (gl, gr, len(gs)) == (wl, wr, len(ws)), (g, w)
            steps = [abs(SHADES.index(a) - SHADES.index(b))
                     for a, b in zip(gs, ws)]
            assert max(steps) <= 1, (g, w)
            continue
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        gn = [float(x) for x in NUMBER.findall(g)]
        wn = [float(x) for x in NUMBER.findall(w)]
        np.testing.assert_allclose(gn, wn, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{g!r} against {w!r}")


def test_interleave_demo_matches_reference(card_route, capsys):
    before = nc.LAUNCH_COUNT
    out = interleave_demo.main(["--sim-time", str(SIM_TIME),
                                "--device", "cpu"])
    got = capsys.readouterr().out
    ref = _reference_script("interleave_demo")
    ref.SIM_TIME = SIM_TIME
    ref.SPEC = ref.netsim.TelemetrySpec(
        probes=ref.SPEC.probes,
        stride=int(round(SIM_TIME / ref.DT)) // interleave_demo.SAMPLES)
    assert interleave_demo.telemetry_spec(SIM_TIME).stride == ref.SPEC.stride
    with reference_modules():
        ref.main()
    want = capsys.readouterr().out
    _assert_same_lines(got, want)
    # both schemes on the armed chunk kernel, one launch a chunk
    cfg = interleave_demo.make_plan(SIM_TIME).build({"scheme": "mltcp"})
    n_chunks = cfg.n_ticks // max(1, cfg.n_ticks // cfg.n_chunks)
    assert out["n_compile_groups"] == 2 and out["n_kernel_fallbacks"] == 0
    assert out["n_kernel_launches"] == nc.LAUNCH_COUNT - before == \
        2 * n_chunks
    assert math.isfinite(out["tti_s"]) and not out["default_converged"]


def test_simulate_cluster_matches_reference(card_route, capsys,
                                            monkeypatch):
    v5e = HwSpec(**dataclasses.asdict(
        load_reference()["repro.roofline.hw"].V5E))
    monkeypatch.setattr(simulate_cluster, "simulate_shared_cluster",
                        functools.partial(cluster.simulate_shared_cluster,
                                          hw=v5e))
    before = nc.LAUNCH_COUNT
    rep = simulate_cluster.main(["--sim-time", str(SIM_TIME),
                                 "--device", "cpu"])
    got = capsys.readouterr().out
    assert nc.LAUNCH_COUNT > before
    ref = _reference_script("simulate_cluster")
    run = ref.simulate_shared_cluster
    ref.simulate_shared_cluster = lambda jobs, **kw: run(
        jobs, **{**kw, "sim_time": SIM_TIME})
    with reference_modules():
        ref.main()
    want = capsys.readouterr().out
    _assert_same_lines(got, want)
    assert rep.jobs == simulate_cluster.JOBS


def test_quickstart_learns_and_writes_its_checkpoint(tmp_path, capsys):
    steps = 16
    out = quickstart.main(["--steps", str(steps), "--ckpt-dir",
                           str(tmp_path), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert out["steps"] == steps and len(out["losses"]) == steps
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["last_loss"] < out["first_loss"]
    assert lines[-2:] == [
        f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f}",
        "quickstart OK: the model is learning."]
    assert CheckpointManager(str(tmp_path)).latest_step() == steps


def test_serve_lm_is_the_launcher(capsys):
    out = serve_lm.main(["--batch", "2", "--prompt-len", "8", "--new", "3",
                         "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    ids = out["generated"]
    assert lines[0] == "generated ids:" and len(lines) == 2 + ids.shape[0]
    assert re.fullmatch(r"prefill [\d.]+ ms; decode [\d.]+ tok/s on cpu",
                        lines[-1])
    want = serve("recurrentgemma-2b", batch=2, prompt_len=8, new_tokens=3,
                 preset="smoke", device="cpu")["generated"]
    assert tuple(ids.shape) == (2, 3) and torch.equal(ids, want)
