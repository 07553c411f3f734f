"""The chunk kernel's body built for the CPU, for the port's tests.

``csrc/netsim_chunk.cu`` compiles with a host C++ compiler too
(``csrc/host_compat.cuh`` stands in for the CUDA keywords; each CTA runs
as host threads meeting at a barrier).  That build runs the kernel's
logic, armed specializations included, at C speed on the CPU: the tests
hold it bit for bit against the per-tick path, and run longer
simulations through it than the per-tick path could afford.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

from repro_torch.kernels import netsim_chunk as nc
from repro_torch.netsim import engine

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
HOST_FLAGS = ("-std=c++20", "-O0", "-ffp-contract=off", "-fno-fast-math",
              "-shared", "-fPIC", "-pthread", "-x", "c++")


def compiler():
    return shutil.which("g++") or shutil.which("c++")


def build_host_library(out_dir: Path) -> ctypes.CDLL:
    """Compile the kernel's body into ``out_dir`` and bind its C entries."""
    out = Path(out_dir) / "netsim_chunk_host.so"
    subprocess.run([compiler(), *HOST_FLAGS, "-o", str(out),
                    str(CSRC / "netsim_chunk.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.netsim_chunk_host.restype = ctypes.c_int
    lib.netsim_chunk_host.argtypes = [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
    lib.netsim_chunk_smem_bytes.restype = ctypes.c_longlong
    lib.netsim_chunk_smem_bytes.argtypes = [ctypes.c_void_p]
    nc.bind_draws(lib)
    return lib


def host_launch(lib, threads):
    """`netsim_chunk.launch` on the host build of the kernel's body, with
    the operands the card gets; checks the library's shared-memory size
    against `netsim_chunk.smem_bytes`."""
    def launch(run, cs, inputs, traces, chunk):
        operands, dims, scalars, consts = nc.launch_arguments(
            run, cs, inputs, traces, chunk)
        d = dict(zip(nc.DIMS, dims))
        tel = d["D_ARMED"] & nc.ARM_TEL
        pairs = d["D_J"] * (d["D_J"] - 1) // 2 if d["D_INTERLEAVE"] else 0
        assert lib.netsim_chunk_smem_bytes(
            ctypes.cast(dims, ctypes.c_void_p)) == nc.smem_bytes(
                d["D_M"], d["D_N"], d["D_J"], d["D_S"], d["D_D"], d["D_P"],
                d["D_ARMED"], pairs if tel else 0, d["D_BINS"],
                d["D_EVENTS"])
        rc = lib.netsim_chunk_host(
            *nc.specialization(run), ctypes.cast(operands, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p),
            ctypes.cast(scalars, ctypes.c_void_p),
            ctypes.cast(consts, ctypes.c_void_p),
            run.cc.fast_recovery_stages, threads)
        assert rc == 0
    return launch


def host_run_ticks(lib, cfg, sweep, threads: int = 2) -> engine.RawSimOutput:
    """A whole run as `engine.run_ticks` takes it on the card (the state
    packed once, one launch per chunk, the traces and the telemetry
    written by the kernel), on the host build."""
    dev = sweep.slope.device
    statics = engine._build_statics(cfg, dev)
    wl = engine._workload_view(cfg, statics, sweep)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    n_chunks = cfg.n_ticks // tpc
    chunks = nc.ChunkRun(nc.prepare(cfg, statics, sweep, wl),
                         engine._init_state(cfg, statics, sweep), n_chunks,
                         launch_fn=host_launch(lib, threads))
    for _ in range(n_chunks):
        chunks.step(engine.chunk_inputs(cfg, statics, sweep, chunks, tpc))
    st = chunks.state()
    return engine.RawSimOutput(
        iter_times=st.iter_times, iter_counts=st.iter_idx,
        **dict(zip(engine.CHUNK_FIELDS, chunks.traces)), final_state=st,
        telemetry=st.telemetry)
