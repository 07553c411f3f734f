"""Launch-contract lint: prove, per group, that the chunk kernel's launch
is one the library builds, fits the card, and gets the operands it
indexes.

The JAX package's kernel lint (``repro/analysis/kernel_lint.py``) walked
the Pallas kernel's body for memory spaces, tiles and body ops.  The
port's kernel is hand-written CUDA whose body is held bit for bit against
its plain version on the card (``chip_smoke.py``); what can still go wrong
between the Python side and the library is the launch, so this layer
checks that statically, on any device, from the very functions the launch
runs (`netsim_chunk.prepare`, `pack_state`, `engine.chunk_inputs`,
`netsim_chunk.launch_arguments`):

* the group's ``(algo, variant, aggregate, factors, ARMED)`` is a built
  specialization: one of the 48 CC specializations, unarmed or under any
  ARMED (``kernel/unbuilt-specialization``);
* a point's shared memory, ``smem_bytes(**shape_of(cfg))``, is under a
  configurable ceiling and under the card's ``SMEM_LIMIT``
  (``kernel/smem-budget``);
* ``threads_for`` is at most ``MAX_THREADS``, and is what `prepare`
  packed (``kernel/threads``);
* every operand `prepare`, `pack_state`, `chunk_inputs` and `new_traces`
  build has the dtype, shape and contiguity the kernel indexes by, and
  `launch_arguments` accepts one chunk of them
  (``kernel/operand-mismatch``).

On the card `lint_library` also reads the library: the dynamic shared
memory a launch asks for (`launch_smem_bytes`) must equal the prediction
(``kernel/smem-mismatch``), and the specialization's attributes
(`kernel_attributes`) must show no local (spill) bytes
(``kernel/spill``) and a per-block thread limit that covers
``threads_for`` (``kernel/threads``).  Nothing it can predict statically
is read from the runtime.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.analysis.findings import Finding, make_finding
from repro_torch.core.cc.types import Algo, Variant
from repro_torch.kernels import netsim_chunk as nc

__all__ = ["DEFAULT_SMEM_CEILING_BYTES", "CC_SPECIALIZATIONS",
           "built_specializations", "specialization_of", "LaunchSetup",
           "launch_setup", "operand_contract", "lint_operands",
           "lint_kernel", "lint_library"]

# Shared-memory ceiling per point for the static check: half the card's
# per-block limit, the most at which two CTAs (two sweep points) still
# share an SM.  The CI plans' points need a few KB; a runaway layout trips
# this long before the launch itself would be refused at SMEM_LIMIT.
DEFAULT_SMEM_CEILING_BYTES = nc.SMEM_LIMIT // 2

# The CC specializations: every algorithm and variant, with and without
# job-aggregated statistics and Static factors (48).  The library
# instantiates each unarmed; armed, one kernel per algorithm takes them
# all as launch dims.
CC_SPECIALIZATIONS = frozenset(
    (int(a), int(v), agg, fac) for a in Algo for v in Variant
    for agg in (False, True) for fac in (False, True))


def built_specializations() -> frozenset:
    """Every (algo, variant, aggregate, factors, ARMED) the library
    runs: the 48 CC specializations at each ARMED, 0 (unarmed) to 3."""
    armed = (0, nc.ARM_TEL, nc.ARM_FAULTS, nc.ARM_TEL | nc.ARM_FAULTS)
    return frozenset(s + (a,) for s in CC_SPECIALIZATIONS for a in armed)


def specialization_of(cfg, sweep) -> tuple:
    """(algo, variant, aggregate, factors, ARMED) of a group's launch."""
    cc = cfg.protocol.cc
    return (int(cc.algo), int(cc.variant),
            bool(cfg.protocol.aggregate_by_job),
            sweep.static_job_factors is not None, nc.armed_bits(cfg))


class LaunchSetup(NamedTuple):
    """One group's launch as the card's `engine.run_ticks` prepares it,
    built on the CPU: the packed run constants and state, the first
    chunk's inputs and the run's trace buffers."""

    statics: object
    wl: object
    st: object
    run: nc.RunOperands
    cs: nc.ChunkState
    inputs: object           # engine.TickInputs of chunk 0
    traces: tuple
    n_chunks: int
    ticks_per_chunk: int


def launch_setup(cfg, sweep, state=None) -> LaunchSetup:
    """Pack a group's launch on the CPU.  ``state`` is
    `dispatch_lint.initial_state`'s (statics, wl, st), built when None."""
    from repro_torch.analysis import dispatch_lint
    from repro_torch.netsim import engine

    sweep = engine.SweepParams(*[None if v is None else v.cpu()
                                 for v in sweep])
    statics, wl, st = (dispatch_lint.initial_state(cfg, sweep)
                       if state is None else state)
    ticks_per_chunk = max(1, cfg.n_ticks // cfg.n_chunks)
    n_chunks = cfg.n_ticks // ticks_per_chunk
    cs = nc.pack_state(st)
    return LaunchSetup(
        statics=statics, wl=wl, st=st,
        run=nc.prepare(cfg, statics, sweep, wl), cs=cs,
        inputs=engine.chunk_inputs(cfg, statics, sweep, st, ticks_per_chunk),
        traces=nc.traces_for(cs, n_chunks), n_chunks=n_chunks,
        ticks_per_chunk=ticks_per_chunk)


def operand_contract(run: nc.RunOperands, shape: dict, factors: bool,
                     job_active: bool) -> dict:
    """name -> (shape, dtype) the kernel indexes each state and run
    operand by (None: the operand must be absent), from the run's dims
    and `shape_of`'s armed dimensions."""
    d = run.dims
    K, M, N, J = d["D_K"], d["D_M"], d["D_N"], d["D_J"]
    S, D, P, I = d["D_S"], d["D_D"], d["D_P"], d["D_MAX_ITERS"]
    L = M + 1
    f32, i32, b = torch.float32, torch.int32, torch.bool
    out = {
        "fflow": ((len(nc.FLOW_FIELDS), K, N), f32),
        "iflow": ((len(nc.IFLOW_FIELDS), K, N), i32),
        "link": ((len(nc.LINK_FIELDS), K, L, N), f32),
        "ring_del": ((K, D, N), f32),
        "ring_flags": ((len(nc.RING_FLAG_FIELDS), K, D, N), b),
        "fjob": ((len(nc.FJOB_FIELDS), K, J), f32),
        "ijob": ((len(nc.IJOB_FIELDS), K, J), i32),
        "point": ((len(nc.POINT_FIELDS), K), i32),
        "iter_times": ((K, J, I), f32),
        "acc": ((K * M + 2 * K + K * J,), f32),
        "params": ((K, len(nc.PARAM_FIELDS)), f32),
        "flow_total": ((K, N), f32),
        "factors": ((K, N), f32) if factors else None,
        "job_tables": ((K, 2, J, P), f32),
        "cassini": ((K, 2, J), f32) if d["D_CASSINI"] else None,
        "static_ints": ((2 * N + J * S + J + L * N,), i32),
        "static_floats": ((N + M + 2 * L * N + J,), f32),
        "job_active": ((K, J), b) if job_active else None,
    }
    tel = bool(d["D_ARMED"] & nc.ARM_TEL)
    cap, width = d["D_CAP"], d["D_SERIES_W"]
    out.update({
        "tel_f": ((K, 2 * shape["P2"]), f32),
        "tel_i": ((len(nc.TEL_INT_FIELDS), K), i32),
        "tel_hist": ((K, J, shape["B"]), i32),
        "tel_ev": ((len(nc.TEL_EV_FIELDS), K, shape["E"]), i32),
        "series": ((K, cap, width), f32),
        "sample_tick": ((K, cap), i32),
    } if tel else dict.fromkeys(
        ("tel_f", "tel_i", "tel_hist", "tel_ev", "series", "sample_tick")))
    return out


def lint_operands(run: nc.RunOperands, cs: nc.ChunkState, contract: dict,
                  *, label: str, inputs=None, traces=None
                  ) -> list[Finding]:
    """Hold the state and run operands to ``contract``
    (`operand_contract`), then, given a chunk's ``inputs`` and the run's
    ``traces``, hand one chunk to `launch_arguments`, whose checks the
    launch runs."""
    findings = []

    def bad(msg):
        findings.append(make_finding("kernel/operand-mismatch", label, msg))

    ops = {**run._asdict(), **cs._asdict()}
    for name, want in contract.items():
        t = ops[name]
        if want is None:
            if t is not None:
                bad(f"{name} is passed but this specialization takes none")
            continue
        shape, dtype = want
        if t is None:
            bad(f"{name} is missing (expected {dtype} {shape})")
        elif t.dtype != dtype or tuple(t.shape) != shape:
            bad(f"{name} is {t.dtype} {tuple(t.shape)}, the kernel indexes "
                f"{dtype} {shape}")
        elif not t.is_contiguous():
            bad(f"{name} is not contiguous")
    if inputs is not None:
        try:
            nc.launch_arguments(run, cs, inputs, traces, 0)
        except (ValueError, TypeError) as e:
            bad(f"launch_arguments refuses chunk 0: {e}")
    return findings


def lint_kernel(cfg, sweep, *, label: str,
                setup: Optional[LaunchSetup] = None,
                smem_ceiling_bytes: int = DEFAULT_SMEM_CEILING_BYTES
                ) -> tuple[list[Finding], dict]:
    """The static launch contract of one group (which the dispatch sends
    through the chunk kernel).  Returns (findings, facts): the
    specialization, ``smem_bytes`` and ``threads``."""
    findings: list[Finding] = []
    setup = launch_setup(cfg, sweep) if setup is None else setup
    spec = specialization_of(cfg, sweep)
    built = spec in built_specializations()
    if not built:
        findings.append(make_finding(
            "kernel/unbuilt-specialization", label,
            f"(algo, variant, aggregate, factors, ARMED) = {spec} is not "
            f"instantiated by netsim_chunk.cu"))
    shape = nc.shape_of(cfg)
    need = nc.smem_bytes(**shape)
    for limit, what in ((smem_ceiling_bytes, "the lint's ceiling"),
                        (nc.SMEM_LIMIT, "the card's SMEM_LIMIT")):
        if need > limit:
            findings.append(make_finding(
                "kernel/smem-budget", label,
                f"a point needs {need} B of shared memory, over {what} "
                f"({limit} B); shape {shape}"))
    threads = nc.threads_for(shape["M"], shape["N"], shape["J"])
    if threads > nc.MAX_THREADS:
        findings.append(make_finding(
            "kernel/threads", label,
            f"threads_for gives {threads} threads, over MAX_THREADS "
            f"({nc.MAX_THREADS}, the kernel's __launch_bounds__)"))
    if setup.run.threads != threads:
        findings.append(make_finding(
            "kernel/threads", label,
            f"prepare packed {setup.run.threads} threads, threads_for "
            f"gives {threads}"))
    contract = operand_contract(setup.run, shape,
                                factors=spec[3],
                                job_active=sweep.job_active is not None)
    findings.extend(lint_operands(setup.run, setup.cs, contract, label=label,
                                  inputs=setup.inputs, traces=setup.traces))
    return findings, dict(specialization=list(spec), smem_bytes=need,
                          threads=threads)


def lint_library(cfg, sweep, *, label: str, setup: LaunchSetup
                 ) -> tuple[list[Finding], dict]:
    """The library's side of a built specialization's launch, on the
    card: its launch shared memory against the prediction, its spills and
    its thread limit (`lint_kernel` holds the rest).  Returns (findings, facts): ``library_smem_bytes``
    and `kernel_attributes`' ``registers``, ``local_bytes``,
    ``static_smem_bytes`` and ``max_threads``."""
    findings: list[Finding] = []
    spec = specialization_of(cfg, sweep)
    shape = nc.shape_of(cfg)
    need = nc.smem_bytes(**shape)
    threads = nc.threads_for(shape["M"], shape["N"], shape["J"])
    lib_smem = nc.launch_smem_bytes(setup.run)
    attrs = nc.kernel_attributes(*spec)
    if lib_smem != need:
        findings.append(make_finding(
            "kernel/smem-mismatch", label,
            f"the library asks {lib_smem} B of dynamic shared memory, "
            f"netsim_chunk.smem_bytes predicts {need} B"))
    if attrs["local_bytes"]:
        findings.append(make_finding(
            "kernel/spill", label,
            f"specialization {spec} uses {attrs['local_bytes']} B of "
            f"local memory per thread ({attrs['registers']} registers)"))
    if attrs["max_threads"] < threads:
        findings.append(make_finding(
            "kernel/threads", label,
            f"the runtime allows {attrs['max_threads']} threads a block "
            f"for {spec}, the launch takes {threads}"))
    return findings, dict(library_smem_bytes=lib_smem, **attrs)
