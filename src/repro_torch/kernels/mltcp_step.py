"""The fused MLTCP congestion-control tick: a CUDA kernel for Hopper, its
plain PyTorch version, its build and its launch counter.

One launch advances every flow of every sweep point one simulator tick:
Algorithm 1 (boundary test, ``iter_gap`` EWMA, ``max_gap``, per-flow or
job-aggregated ``bytes_ratio``), F (the linear slope·ratio + intercept
or one of the paper's F1..F6, `F_IDS`) with the optional Static factors
(>= 0 replaces F, < 0 keeps it), WI/MD routing, and the Reno, CUBIC or
DCQCN update.

It replaces the Pallas TPU kernel ``repro/kernels/mltcp_step.py::_kernel``
(launched by ``mltcp_tick_arrays``).  The TPU form packs flows into
[R, 128] lanes padded to 1024 and carries the protocol scalars in SMEM;
here state is ``[K, N]`` contiguous, one thread per (k, n) over a 1-D grid
of K·N with the ragged edge masked, ``dyn`` is ``[K, 5]`` (each thread
reads its point's row) and ``now`` is ``[K]``.  ``algo``, ``variant``,
``aggregate`` and the presence of factors are template parameters chosen
on the host, as the TPU kernel specializes at trace time; the F family is
a launch argument (``f_id``), one for every flow of the launch.

What bounds it: it is a pure byte-mover.  Per flow it reads 20 float32
and one int32 state/feedback values plus two bool signals (86 B, 90 B
with factors; 4 B less without job aggregation) and writes 17 float32
and one int32 (72 B): about 160 B per flow per tick, about 50 ps per flow
at the H100's 3.35 TB/s.  At the
paper's shapes (K·N from 4 to a few hundred flows) it is bound by the
launch, not by memory.

`mltcp_tick_reference` computes the same function in separate torch ops.
The kernel is compiled with ``--fmad=false`` and IEEE division and uses
the same cube root formula (`repro_torch.core.cc.cubic.cbrt`), so on the
card the two agree bit for bit.  `mltcp_tick` launches the kernel for CUDA
tensors and uses the plain version only for CPU tensors; on ``meta``
tensors it plans the launch (``PLANNED_LAUNCHES``) and returns empty
outputs of the kernel's shapes.  The launch goes on the current stream
and calls nothing a CUDA graph capture refuses, so `netsim.tick_graph`
captures it as it is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import aggressiveness, iteration
from repro_torch.core.cc import cubic
from repro_torch.core.cc.types import Algo, Variant
from repro_torch.kernels import build

Tensor = torch.Tensor

DET_FIELDS = ("bytes_sent", "prev_ack_tstamp", "iter_gap", "max_gap")
CC_FIELDS = ("cwnd", "ssthresh", "cooldown", "w_max", "epoch_start",
             "rate_cur", "rate_target", "alpha", "t_last_cnp", "t_last_inc",
             "t_last_alpha")
# per-flow [K, N] operands, in the kernel's pointer order ("now" is [K])
IN_ORDER = (DET_FIELDS + CC_FIELDS
            + ("stage", "prev_ratio", "num_acks", "ack_bytes", "loss", "cnp",
               "total_bytes", "job_numer"))
OUT_ORDER = DET_FIELDS + CC_FIELDS + ("stage", "ratio", "rate")
IN_DTYPES = {"stage": torch.int32, "loss": torch.bool, "cnp": torch.bool}
# Layout of a ``dyn`` row (== core.DynamicParams field order).
DYN_FIELDS = ("slope", "intercept", "g", "gamma", "init_comm_gap")
NDYN = len(DYN_FIELDS)
# The F families the kernels compute (mltcp_cc.cuh's f_value), by the
# kernels' F id: the linear F over the point's slope and intercept, and
# the paper's F1..F6 (core/aggressiveness.py).  Any other F (a callable)
# is not a kernel's (`f_id` raises for it).
F_IDS = {"linear": 0, "F1": 1, "F2": 2, "F3": 3, "F4": 4, "F5": 5, "F6": 6}
F_SPECS = {i: spec for spec, i in F_IDS.items()}

# Launches of the CUDA kernel (never of the plain version).
LAUNCH_COUNT = 0
# Launches planned on meta tensors (a tick traced without a card)
PLANNED_LAUNCHES = 0

BLOCK = 256
# the float constants, in the order of the kernel's `Consts` struct
CONST_FIELDS = ("mss_over_rtt", "rtt", "tick_dt", "min_cwnd", "beta",
                "cubic_c", "cubic_k_scale", "line_rate", "rate_ai",
                "rate_min", "dcqcn_g", "one_minus_g", "alpha_timer",
                "inc_timer", "cnp_interval")


def f_id(f_spec) -> int:
    """The kernels' F id of an F family (`F_IDS`).  Raises ValueError for
    any other F (a callable, an unknown name): no kernel computes it, and
    this is the one place that says which families a kernel takes."""
    if isinstance(f_spec, str) and f_spec in F_IDS:
        return F_IDS[f_spec]
    raise ValueError(f"f_spec={f_spec!r} is none of the kernels' F "
                     f"families {tuple(F_IDS)}")


def static_params(cc, aggregate: bool, f_spec="linear") -> dict:
    """The kernel's static specialization from a `CCParams`, and the F
    family of the launch."""
    return {"algo": int(cc.algo), "variant": int(cc.variant),
            "aggregate": bool(aggregate), "cc": cc, "f_id": f_id(f_spec)}


def _consts(cc) -> dict:
    """Python-float constants, folded exactly as the plain version folds
    them (each becomes one float32 when it meets a float32 tensor)."""
    c = cc.cubic_c * cc.cubic_scale
    beta = cc.reno_beta if cc.algo == Algo.RENO else cc.cubic_beta
    return {"mss_over_rtt": cc.mss / cc.rtt, "rtt": cc.rtt,
            "tick_dt": cc.tick_dt, "min_cwnd": cc.min_cwnd, "beta": beta,
            "cubic_c": c, "cubic_k_scale": (1.0 - cc.cubic_beta) / c,
            "line_rate": cc.line_rate, "rate_ai": cc.rate_ai,
            "rate_min": cc.rate_min, "dcqcn_g": cc.dcqcn_g,
            "one_minus_g": 1.0 - cc.dcqcn_g, "alpha_timer": cc.alpha_timer,
            "inc_timer": cc.inc_timer, "cnp_interval": cc.cnp_interval}


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def mltcp_tick_reference(p: dict, dyn: Tensor, arrays: dict, now: Tensor,
                         static_factors: Tensor | None = None) -> dict:
    """The kernel's function in separate torch ops (same signature).

    ``p``: `static_params` (its ``f_id`` names F: the linear F over the
    point's slope and intercept, or one of `core.aggressiveness`'s
    F1..F6); ``dyn``: [K, 5] per DYN_FIELDS; ``arrays``:
    {field: [K, N]} per IN_ORDER ("job_numer" only when aggregating);
    ``now``: [K]; ``static_factors``: optional [K, N].  Returns {field:
    [K, N]} per OUT_ORDER.  Op for op the arithmetic of `core.cc_tick`.
    """
    cc, k = p["cc"], _consts(p["cc"])
    slope, intercept, g, gamma, init_gap = dyn.unbind(-1)
    slope, intercept, g, gamma, init_gap = (
        x.unsqueeze(-1) for x in (slope, intercept, g, gamma, init_gap))
    now = now.unsqueeze(-1)
    a = arrays
    acks = a["num_acks"]
    has_ack = acks > 0.0

    # ---------------- Algorithm 1 (core.iteration semantics) --------------
    bytes_sent = a["bytes_sent"] + a["ack_bytes"]
    curr_gap = now - a["prev_ack_tstamp"]
    max_gap = torch.maximum(a["max_gap"], curr_gap)
    new_iter = curr_gap > g * a["iter_gap"]
    iter_gap_upd = (1.0 - gamma) * a["iter_gap"] + gamma * max_gap
    numer = a["job_numer"] if p["aggregate"] else bytes_sent
    ratio_mid = iteration.byte_ratio(numer, a["total_bytes"])

    boundary = has_ack & new_iter
    out = {}
    out["bytes_sent"] = torch.where(
        boundary, 0.0, torch.where(has_ack, bytes_sent, a["bytes_sent"]))
    ratio = torch.where(boundary, 0.0,
                        torch.where(has_ack, ratio_mid, a["prev_ratio"]))
    out["ratio"] = ratio
    out["prev_ack_tstamp"] = torch.where(has_ack, now, a["prev_ack_tstamp"])
    out["iter_gap"] = torch.where(boundary, iter_gap_upd, a["iter_gap"])
    out["max_gap"] = torch.where(
        boundary, init_gap, torch.where(has_ack, max_gap, a["max_gap"]))

    # ---------------- F(bytes_ratio), variant routing ----------------
    variant = p["variant"]
    if variant == int(Variant.OFF):
        adaptive = torch.ones_like(ratio)
    else:
        adaptive = aggressiveness.make_fn(F_SPECS[p["f_id"]], slope,
                                          intercept)(ratio)
    if static_factors is not None:
        f_vals = torch.where(static_factors >= 0.0, static_factors, adaptive)
    else:
        f_vals = adaptive
    one = torch.ones_like(f_vals)
    f_wi = f_vals if variant in (int(Variant.WI), int(Variant.BOTH)) else one
    f_md = f_vals if variant in (int(Variant.MD), int(Variant.BOTH)) else one

    loss, cnp_sig = a["loss"], a["cnp"]
    algo = p["algo"]
    for name in CC_FIELDS + ("stage",):
        out[name] = a[name]
    if algo in (int(Algo.RENO), int(Algo.CUBIC)):
        cwnd = a["cwnd"]
        in_ss = cwnd < a["ssthresh"]
        if algo == int(Algo.RENO):
            grow_ca = f_wi * acks / torch.clamp_min(cwnd, 1e-6)   # Eq. 5
        else:
            tt = torch.clamp_min(now - a["epoch_start"], 0.0)
            kk = cubic.cbrt(a["w_max"] * k["cubic_k_scale"])
            d = f_wi * tt - kk
            target = k["cubic_c"] * (d * d * d) + a["w_max"]       # Eq. 9
            grow = (acks * torch.clamp_min(target - cwnd, 0.0)
                    / torch.clamp_min(cwnd, 1e-6))
            grow_ca = torch.minimum(grow, 0.5 * cwnd + 1.0)
        cwnd_inc = cwnd + torch.where(in_ss, acks, grow_ca)
        do_cut = loss & (a["cooldown"] <= 0.0)
        cwnd_cut = torch.clamp_min(                                 # Eq. 7/11
            torch.clamp_max(f_md * k["beta"], 1.0) * cwnd, k["min_cwnd"])
        out["cwnd"] = torch.where(do_cut, cwnd_cut, cwnd_inc)
        out["ssthresh"] = torch.where(do_cut, torch.clamp_min(cwnd_cut, 2.0),
                                      a["ssthresh"])
        out["cooldown"] = torch.where(
            do_cut, k["rtt"],
            torch.clamp_min(a["cooldown"] - k["tick_dt"], 0.0))
        if algo == int(Algo.CUBIC):
            out["w_max"] = torch.where(do_cut, cwnd, a["w_max"])
            out["epoch_start"] = torch.where(do_cut, now, a["epoch_start"])
        out["rate"] = out["cwnd"] * k["mss_over_rtt"]   # == core send_rate
    else:  # ---------------- DCQCN ----------------
        rate_cur, alpha = a["rate_cur"], a["alpha"]
        cnp = cnp_sig & ((now - a["t_last_cnp"]) >= k["cnp_interval"])
        alpha_on_cnp = k["one_minus_g"] * alpha + k["dcqcn_g"]
        md_mult = torch.clamp_max(f_md * (1.0 - alpha / 2.0), 1.0)  # Eq. 15
        rate_cut = torch.clamp(md_mult * rate_cur, k["rate_min"],
                               k["line_rate"])
        alpha_fired = (now - a["t_last_alpha"]) >= k["alpha_timer"]
        alpha_dec = torch.where(alpha_fired, k["one_minus_g"] * alpha, alpha)
        inc_fired = (now - a["t_last_inc"]) >= k["inc_timer"]
        stage = a["stage"] + inc_fired.to(torch.int32)
        in_ai = stage > cc.fast_recovery_stages
        tgt_inc = torch.where(inc_fired & in_ai,
                              a["rate_target"] + f_wi * k["rate_ai"],  # Eq. 13
                              a["rate_target"])
        tgt_inc = torch.clamp_max(tgt_inc, k["line_rate"])
        step_up = torch.clamp_max(f_wi, 2.0) * 0.5 * (tgt_inc - rate_cur)
        rate_inc = torch.where(inc_fired, rate_cur + step_up, rate_cur)
        out["rate_cur"] = torch.clamp(torch.where(cnp, rate_cut, rate_inc),
                                      k["rate_min"], k["line_rate"])
        out["rate_target"] = torch.clamp(torch.where(cnp, rate_cur, tgt_inc),
                                         k["rate_min"], k["line_rate"])
        out["alpha"] = torch.clamp(torch.where(cnp, alpha_on_cnp, alpha_dec),
                                   0.0, 1.0)
        out["stage"] = torch.where(cnp, torch.zeros_like(stage), stage)
        out["t_last_cnp"] = torch.where(cnp, now, a["t_last_cnp"])
        out["t_last_inc"] = torch.where(cnp | inc_fired, now, a["t_last_inc"])
        out["t_last_alpha"] = torch.where(cnp | alpha_fired, now,
                                          a["t_last_alpha"])
        out["rate"] = out["rate_cur"]
    return {name: out[name] for name in OUT_ORDER}


# ---------------------------------------------------------------------------
# Build and launch
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    lib.mltcp_step_launch.restype = ctypes.c_int
    lib.mltcp_step_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


LIBRARY = build.KernelLibrary("mltcp_step", _bind)


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if not isinstance(t, Tensor):
        raise TypeError(f"mltcp_tick: {name!r} is not a tensor")
    if t.device != device:
        raise ValueError(f"mltcp_tick: {name!r} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"mltcp_tick: {name!r} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mltcp_tick: {name!r} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"mltcp_tick: {name!r} is not contiguous")


def mltcp_tick(p: dict, dyn: Tensor, arrays: dict, now: Tensor,
               static_factors: Tensor | None = None) -> dict:
    """Run the fused tick: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, a planned launch (empty outputs) for meta
    tensors.  Same signature as `mltcp_tick_reference`.

    Checks every operand's device, dtype, shape and contiguity and raises
    on anything the kernel does not take.  On the card it allocates the
    outputs, launches on the current stream without synchronizing, raises
    if the launch was refused, and counts the launch in `LAUNCH_COUNT`.
    """
    global LAUNCH_COUNT, PLANNED_LAUNCHES
    ref = arrays["cwnd"]
    device = ref.device
    if ref.ndim != 2:
        raise ValueError(f"mltcp_tick: state must be [K, N], got "
                         f"{tuple(ref.shape)}")
    k, n = ref.shape
    names = IN_ORDER if p["aggregate"] else IN_ORDER[:-1]
    for name in names:
        _check(name, arrays[name], (k, n), IN_DTYPES.get(name, torch.float32),
               device)
    _check("dyn", dyn, (k, NDYN), torch.float32, device)
    _check("now", now, (k,), torch.float32, device)
    if static_factors is not None:
        _check("static_factors", static_factors, (k, n), torch.float32,
               device)
    if device.type == "cpu":
        return mltcp_tick_reference(p, dyn, arrays, now, static_factors)
    if device.type == "meta":
        PLANNED_LAUNCHES += 1
        return {name: torch.empty((k, n), device=device, dtype=(
            torch.int32 if name == "stage" else torch.float32))
            for name in OUT_ORDER}
    if device.type != "cuda":
        raise ValueError(f"mltcp_tick: no kernel for device {device}")

    lib = LIBRARY.load()
    fout = torch.empty((len(OUT_ORDER) - 1, k, n), dtype=torch.float32,
                       device=device)
    stage_out = torch.empty((k, n), dtype=torch.int32, device=device)
    outs = {}
    fi = 0
    for name in OUT_ORDER:
        if name == "stage":
            outs[name] = stage_out
        else:
            outs[name] = fout[fi]
            fi += 1
    if k * n == 0:
        return outs
    in_ptrs = (ctypes.c_void_p * len(IN_ORDER))(*[
        arrays[name].data_ptr() if name in names else None
        for name in IN_ORDER])
    out_ptrs = (ctypes.c_void_p * len(OUT_ORDER))(*[
        outs[name].data_ptr() for name in OUT_ORDER])
    consts = _consts(p["cc"])
    cvals = (ctypes.c_float * len(CONST_FIELDS))(*[
        consts[f] for f in CONST_FIELDS])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mltcp_step_launch(
            p["algo"], p["variant"], int(p["aggregate"]),
            int(static_factors is not None),
            ctypes.cast(in_ptrs, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p),
            ctypes.cast(cvals, ctypes.c_void_p),
            p["cc"].fast_recovery_stages,
            dyn.data_ptr(), now.data_ptr(),
            None if static_factors is None else static_factors.data_ptr(),
            p["f_id"], k, n, stream)
    build.check_launch("mltcp_step", rc)
    LAUNCH_COUNT += 1
    return outs
