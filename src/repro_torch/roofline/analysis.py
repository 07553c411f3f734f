"""Roofline analysis: per (arch x shape) cell, from the dry run's count
(`repro_torch.launch.dryrun`, the kernel route), the three roofline terms
of one device (`hw.H100`):

  compute    = FLOPs per device          / peak FLOP/s of the cell's dtype
               (989e12 bf16, the reference's cells; 67e12 float32)
  memory     = bytes accessed per device / HBM bandwidth (3.35e12)
  collective = collective bytes per device / one NVLink link (50e9),
               the reference's formula with the card's ``ici_link_bw``

On one card (``mesh="card"``) the collective term is 0.  On the 16x16
or 2x16x16 mesh (``mesh="16x16"``, ``"2x16x16"``) each term is per device
of the mesh (rank 0's share, counted on a fake process group:
`launch.dryrun.run_mesh_cell`), the collective bytes those DTensor issues
(`roofline.collectives`), and ``useful_flops_ratio`` is `model_flops`
over the FLOPs of the whole mesh, as the reference computes it.  A mesh
cell is counted as the reference's roofline counts it: by
``ShardingRules(data_axes=...)`` (`launch.dryrun.reference_rules`) unless
the caller gives ``rules``, the four hillclimb knobs as the caller left
them, one microbatch, on either route (``use_kernel``: the kernels, the
card's; or the plain path, the reference's own).  Every record states
what it was counted under: ``rules``, ``knobs``, ``route`` and, where
given, ``label``.  Records read from a dry run's output (``--dryrun``)
keep the dry run's production rules and knobs, and say so.

The port of ``repro/roofline/analysis.py``.  XLA's cost analysis counts a
scanned layer body once, so the reference lowers every cell again at one
and two layer groups, unrolled, and extrapolates to the full depth
(`_extrapolate`, FLOPs, bytes and collective bytes).  The port's layers
run as a Python loop and the dry run sees every op at full depth, so it
needs no extrapolation; `_extrapolate` and `_reduced_cfg` stay, and the
tests hold a full-depth count equal to the extrapolation of its one- and
two-group counts, on the mesh too.

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.analysis --out results/roofline_torch.json
  PYTHONPATH=src python -m repro_torch.roofline.analysis --mesh both \
      --dryrun results/dryrun_mesh_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as meshes
from repro_torch.models import transformer
from repro_torch.roofline.hw import H100, HwSpec


def _reduced_cfg(cfg, n_groups: int):
    """Same lead/tail structure, n_groups repetitions of the pattern."""
    lead = cfg.first_k_dense
    plen = len(cfg.block_pattern)
    full_rest = cfg.n_layers - lead
    tail = full_rest - (full_rest // plen) * plen
    n_layers = lead + n_groups * plen + tail
    enc = cfg.enc_layers
    return dataclasses.replace(cfg, n_layers=n_layers,
                               enc_layers=min(enc, n_groups * plen) if enc
                               else 0)


def _measure(cfg, shape_name: str, rows: Optional[int] = None,
             seq_len: Optional[int] = None, mesh=None, rules=None) -> dict:
    """One cell's kernel-route count in the reference's ``_measure`` form
    (one microbatch), per device of ``mesh`` (a meta ``DeviceMesh``, by
    ``rules``, default `launch.dryrun.reference_rules`; None: one card,
    no collectives)."""
    if mesh is not None and rules is None:
        rules = dr.reference_rules(mesh)
    got = dr.count_cell(dr.build_cell(cfg, shape_name, rows,
                                      seq_len=seq_len, microbatches=1,
                                      mesh=mesh, rules=rules))
    return {"flops": got["flops"], "bytes": got["bytes"],
            "coll_bytes": got["collectives"]["total_bytes"],
            "coll_by_kind": got["collectives"]["bytes_by_kind"]}


def _extrapolate(m1: dict, m2: dict, g_full: int) -> dict:
    out = {}
    for key in ("flops", "bytes", "coll_bytes"):
        body = m2[key] - m1[key]
        stem = m1[key] - body
        out[key] = max(stem + g_full * body, 0.0)
        out[key + "_body"] = body
        out[key + "_stem"] = stem
    kinds = set(m1["coll_by_kind"]) | set(m2["coll_by_kind"])
    out["coll_by_kind"] = {}
    for k in kinds:
        b = m2["coll_by_kind"].get(k, 0.0) - m1["coll_by_kind"].get(k, 0.0)
        s = m1["coll_by_kind"].get(k, 0.0) - b
        out["coll_by_kind"][k] = s + g_full * b
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens/step."""
    n = transformer.active_param_count(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch          # decode: 1 token per seq


def roofline_terms(record: dict, cfg, shape, hw: HwSpec = H100,
                   n_devices: int = 1) -> dict:
    """The roofline terms of a dry-run record (status "ok") on ``hw``, per
    device of ``n_devices``: compute at the peak of the cell's dtype (bf16
    for every cell of the reference's hyper-parameters; float32 for a
    float32 cell), memory, collective (the record's collective bytes over
    one link), the dominant one, and the useful share of the whole
    mesh's FLOPs."""
    dtype = getattr(torch, record["dtype"])
    flops = record["flops_per_device"]
    colls = record["collectives"]
    coll_bytes = colls["total_bytes"]
    terms = {"compute": flops / hw.peak_flops(dtype),
             "memory": record["bytes_accessed_per_device"] / hw.hbm_bw,
             "collective": coll_bytes / hw.ici_link_bw}
    mf = model_flops(cfg, shape)
    total = flops * n_devices
    return {
        "peak_dtype": str(dtype).replace("torch.", ""),
        "coll_bytes_per_device": coll_bytes,
        "coll_by_kind": dict(colls["bytes_by_kind"]),
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_flops_ratio": mf / total if total else 0.0,
        "roofline_bound_s": max(terms.values()),
        "step_lower_bound_s": max(terms.values()),
    }


def roofline_cell(arch: str, shape_name: str, hw: HwSpec = H100,
                  verbose: bool = True, record: Optional[dict] = None,
                  mesh: str = "card", rules=None, label: str = "",
                  use_kernel: bool = True) -> dict:
    """The dry-run record of one cell (``record``, or counted now: on one
    card, the kernel route, or per device of the ``mesh`` "16x16" or
    "2x16x16" by ``rules``, default the reference roofline's, on the
    route ``use_kernel`` picks) with its roofline terms on ``hw``;
    ``label`` names it (the hillclimb's experiment)."""
    cfg = get_config(arch)
    if record is not None:
        rec = dict(record)
        if rec.get("mesh", "1xH100") != "1xH100" and "rules" not in rec:
            # a dry run's mesh record: its production rules and knobs
            kind = SHAPES[shape_name].kind
            shape = meshes.production_shape(rec["mesh"] == "2x16x16")
            rec["rules"] = dr.rules_record(
                dr.default_rules_for(arch, kind, shape), "production")
            with dr.production_knobs(arch, kind):
                rec["knobs"] = dr.knob_values()
            rec["route"] = "kernel"
    elif mesh == "card":
        if rules is not None or not use_kernel:
            raise ValueError("one card counts the kernel route, without "
                             "sharding rules")
        rec = dr.run_cell(arch, shape_name, verbose=False, plain=False)
    else:
        rec = dr.run_mesh_cell(arch, shape_name, mesh == "2x16x16", rules,
                               verbose=False, use_kernel=use_kernel,
                               production=False)
    if label:
        rec["label"] = label
    if rec["status"] != "ok":
        if verbose and rec["status"] == "error":
            print(f"{arch} x {shape_name}: FAILED {rec['error']}",
                  flush=True)
        return rec
    n = math.prod(int(s) for s in rec["mesh"].split("x")) \
        if rec["mesh"] != "1xH100" else 1
    rec.update(roofline_terms(rec, cfg, SHAPES[shape_name], hw, n))
    if verbose:
        route = f" {rec['route']}" if "route" in rec else ""
        print(f"[{rec['mesh']}{route}] {label or arch:28s} {shape_name:12s} "
              f"comp={rec['t_compute_s'] * 1e3:10.2f}ms "
              f"mem={rec['t_memory_s'] * 1e3:10.2f}ms "
              f"coll={rec['t_collective_s'] * 1e3:10.2f}ms "
              f"dom={rec['dominant']:10s} "
              f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=tuple(dr.MESH_CHOICES),
                    default="card",
                    help="card: one card (the default); single, multi, "
                         "both: per device of the 16x16 and 2x16x16 meshes")
    ap.add_argument("--out", default=None,
                    help="default: results/roofline_torch.json for the "
                         "card, results/roofline_mesh_torch.json for a mesh")
    ap.add_argument("--dryrun", default=None,
                    help="read the dry run's records from this JSON (its "
                         "--out) in place of counting the cells again")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = ("results/roofline_torch.json" if args.mesh == "card"
                    else "results/roofline_mesh_torch.json")
    archs = (args.arch,) if args.arch else ARCH_IDS
    shapes = (args.shape,) if args.shape else tuple(SHAPES)
    labels = ["card" if mp is None else meshes.MESH_LABELS[mp]
              for mp in dr.MESH_CHOICES[args.mesh]]
    t0 = time.perf_counter()
    if args.dryrun:
        with open(args.dryrun) as f:
            counted = {(r["arch"], r["shape"], r["mesh"]): r
                       for r in json.load(f)}
        labels = ["1xH100" if m == "card" else m for m in labels]
        records = [roofline_cell(a, s, record=counted[(a, s, m)])
                   for a in archs for s in shapes for m in labels
                   if (a, s, m) in counted]
    else:
        records = [roofline_cell(a, s, mesh=m) for a in archs
                   for s in shapes for m in labels]
    n_ok = sum(r["status"] == "ok" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"roofline: {n_ok} ok, {n_err} failed in "
          f"{time.perf_counter() - t0:.1f}s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print("wrote", args.out)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
