"""The port stands alone: no JAX, nothing of the reference package.

A fresh interpreter whose import hook refuses ``jax``, ``jaxlib``,
``repro`` and the reference's ``benchmarks`` imports every ``repro_torch``
module (the four examples of ``repro_torch.examples`` among them) and
``chip_smoke``, then
runs a 200-tick simulation, the smoke-preset serve of recurrentgemma-2b, a
2-step smoke-preset training run and one cluster profile on the CPU.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "repro", "benchmarks")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name!r}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
examples = {f"repro_torch.examples.{n}" for n in (
    "quickstart", "serve_lm", "simulate_cluster", "interleave_demo")}
assert examples <= set(names), examples - set(names)
import chip_smoke
from repro_torch import core, netsim
dt = 2e-5
proto = core.MLTCPConfig(cc=core.CCParams(algo=0, variant=1, tick_dt=dt))
cfg = netsim.SimConfig(
    topo=netsim.dumbbell(2, sockets_per_job=2),
    jobs=netsim.JobSpec.simple([0.0025] * 2, [5e6] * 2),
    protocol=proto, sim_time=200 * dt, dt=dt, n_chunks=4)
raw = netsim.simulate(cfg, device="cpu")
assert int(raw.final_state.tick) == 200
from repro_torch.launch.serve import serve
out = serve("recurrentgemma-2b", batch=2, prompt_len=8, new_tokens=3,
            preset="smoke", device="cpu")
assert tuple(out["generated"].shape) == (2, 3)
from repro_torch.launch.train import train
trained = train("recurrentgemma-2b", steps=2, seq_len=12, batch=2,
                device="cpu")
assert trained["steps"] == 2 and all(l == l for l in trained["losses"])
from repro_torch.cluster import profile_from_arch
from repro_torch.configs import get_config
prof = profile_from_arch(get_config("qwen3-1.7b"))
assert prof.comm_bytes[0] > 0 and prof.compute_s[0] > 0
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("MODULES", len(names))
'''


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT])
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split("MODULES")[-1])
    assert n_modules >= 60
