"""Perf hillclimb harness: the port of ``repro/roofline/hillclimb.py``.

Three cells chosen from the baseline roofline table (the reference's
``roofline_cell`` on 16x16: ``ShardingRules(data_axes=...)``, the knobs
at their module defaults; here `roofline.analysis.roofline_cell` with
``mesh="16x16"``, which counts the same way):

  A. qwen1.5-4b  x train_4k   — worst roofline fraction (memory term blows up
     because 20 heads can't shard on the 16-way model axis; every device
     materializes all-head [T, S] attention probs),
  B. qwen3-1.7b  x decode_32k — most collective-bound (the GQA head repeat
     makes the partitioner all-gather the whole KV cache every step),
  C. qwen3-1.7b  x train_4k   — representative of the paper's subject
     (data-parallel training whose gradient/activation collectives are the
     traffic MLTCP schedules),

and D, deepseek-moe-16b x train_4k, the MoE dispatch.  Each experiment:
hypothesis -> change (a sharding rule, or one of the four knobs:
`models.attention.SEQ_SHARD_AXIS`, ``DECODE_GROUPED_GQA``,
`models.moe.DISPATCH_MODE`, ``EP_CONSTRAINT_AXIS``) -> recount ->
verdict, the twelve in the reference's order, with its arguments and its
hypotheses.

The reference counts GSPMD's partitioning of its step with
``use_kernel=False``; here each experiment is counted on both routes
(`launch.dryrun.run_mesh_cell`, rank 0 of a fake group of 256 on the
meta device): the plain path (the reference's search) and the kernels
(the card's; flash never materializes the probabilities, so A1 counts as
A0 there).  Baselines and deltas are taken within a route.  The
hypotheses, and the verdicts in the comments, are the reference's: GSPMD
counts, not DTensor's.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.roofline.hillclimb [--route plain|kernel|both] [--out PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import NamedTuple, Optional

from repro_torch.models import attention, moe
from repro_torch.roofline.analysis import roofline_cell
from repro_torch.train.sharding import ShardingRules

ROUTES = {"plain": (False,), "kernel": (True,), "both": (False, True)}


def _delta(base, new, key):
    b, n = base[key], new[key]
    return f"{b * 1e3:.1f}ms -> {n * 1e3:.1f}ms ({b / max(n, 1e-12):.2f}x)"


@contextlib.contextmanager
def set_knobs(seq_shard=None, grouped_gqa=None, dispatch=None, ep_axis=None):
    """The four knobs set where given (None leaves one as it is), and
    restored on the way out, as the reference's ``experiment`` does."""
    prev_axis = attention.SEQ_SHARD_AXIS
    prev_gqa = attention.DECODE_GROUPED_GQA
    prev_disp = moe.DISPATCH_MODE
    prev_ep = moe.EP_CONSTRAINT_AXIS
    if seq_shard is not None:
        attention.SEQ_SHARD_AXIS = seq_shard
    if grouped_gqa is not None:
        attention.DECODE_GROUPED_GQA = grouped_gqa
    if dispatch is not None:
        moe.DISPATCH_MODE = dispatch
    if ep_axis is not None:
        moe.EP_CONSTRAINT_AXIS = ep_axis
    try:
        yield
    finally:
        attention.SEQ_SHARD_AXIS = prev_axis
        attention.DECODE_GROUPED_GQA = prev_gqa
        moe.DISPATCH_MODE = prev_disp
        moe.EP_CONSTRAINT_AXIS = prev_ep


def experiment(records, name, arch, shape, hypothesis, rules=None,
               seq_shard=None, grouped_gqa=None, dispatch=None,
               ep_axis=None, baseline=None, use_kernel=True):
    """One experiment on one route (``use_kernel``): the knobs set, the
    cell counted on 16x16 by ``rules`` (None: the reference roofline's),
    the knobs restored; the record gains the ``hypothesis`` and, against
    ``baseline`` (the same route's), the deltas of its dominant term and
    of its bound."""
    with set_knobs(seq_shard, grouped_gqa, dispatch, ep_axis):
        rec = roofline_cell(arch, shape, rules=rules, label=name,
                            mesh="16x16", use_kernel=use_kernel)
    rec["hypothesis"] = hypothesis
    if baseline is not None and rec.get("status") == "ok":
        dom = baseline["dominant"]
        key = f"t_{dom}_s"
        rec["dominant_term_delta"] = _delta(baseline, rec, key)
        rec["bound_delta"] = _delta(baseline, rec, "roofline_bound_s")
        print(f"    => {name}: dominant({dom}) {rec['dominant_term_delta']}")
    records.append(rec)
    return rec


class Experiment(NamedTuple):
    """One of the reference's experiments: its cell, hypothesis, rules
    (None: the reference roofline's), knobs (`set_knobs`'s arguments) and
    the experiment it is measured against."""
    name: str
    arch: str
    shape: str
    hypothesis: str
    rules: Optional[ShardingRules] = None
    knobs: dict = {}
    baseline: Optional[str] = None


FSDP = ShardingRules(fsdp=True, data_axes=("data",))
PURE_FSDP = ShardingRules(fsdp=True, tensor_parallel=False,
                          data_axes=("data", "model"))
# the cells' headers, printed before each cell's first experiment
CELLS = {
    "A": "Cell A: qwen1.5-4b train_4k",
    "B": "Cell B: qwen3-1.7b decode_32k",
    "C": "Cell C: qwen3-1.7b train_4k",
    "D": "Cell D: deepseek-moe-16b train_4k (MoE dispatch)",
}
EXPERIMENTS = (
    # Cell A: qwen1.5-4b x train_4k (worst roofline fraction, memory-bound)
    Experiment(
        "A0-baseline", "qwen1.5-4b", "train_4k",
        "baseline: dh-sharded attention (20 heads % 16 != 0) leaves all-head "
        "[B,T,S] probs per device; expect memory-dominated",
        knobs=dict(grouped_gqa=False)),
    Experiment(
        "A1-seq-parallel-attn", "qwen1.5-4b", "train_4k",
        "napkin: probs bytes ~ B*H*T*S*4 per device; sharding the query/"
        "sequence axis of the scores over the 16-way model axis divides the "
        "dominant bytes term by ~16 at the cost of one KV all-gather per "
        "layer (~B*S*K*dh*2 bytes, ~100x smaller)",
        knobs=dict(seq_shard="model", grouped_gqa=False),
        baseline="A0-baseline"),
    # Cell B: qwen3-1.7b x decode_32k (most collective-bound)
    Experiment(
        "B0-baseline", "qwen3-1.7b", "decode_32k",
        "baseline: jnp.repeat KV-head expansion gathers the 2 GiB KV cache "
        "per decoded token; expect collective-dominated",
        knobs=dict(grouped_gqa=False)),
    Experiment(
        "B1-grouped-gqa", "qwen3-1.7b", "decode_32k",
        "napkin: grouped einsum q[B,1,K,g,dh] x cache[B,S,K,dh] needs no "
        "expanded KV; the only collective left should be the psum over the "
        "dh-sharded contraction (~B*H*S*4 bytes, ~1000x less than the cache)",
        knobs=dict(grouped_gqa=True), baseline="B0-baseline"),
    # The reference's B1 verdict (GSPMD): confirmed direction but only 2x,
    # the dh-sharded cache still forcing partial gathers; revised to shard
    # the cache on its sequence axis (context-parallel decode).
    Experiment(
        "B2-seq-sharded-cache", "qwen3-1.7b", "decode_32k",
        "napkin: seq-sharded cache leaves per-step collectives ~ scores "
        "(B*H*S*4 ~ 270 MB) + psum of out (~B*H*dh, KB) instead of "
        "cache-sized gathers; expect another >=2x on the collective term",
        rules=ShardingRules(data_axes=("data",), decode_cache_seq_shard=True),
        knobs=dict(grouped_gqa=True), baseline="B1-grouped-gqa"),
    # Cell C: qwen3-1.7b x train_4k (the paper's own workload shape)
    Experiment(
        "C0-baseline", "qwen3-1.7b", "train_4k",
        "baseline: 16-way tensor parallelism all-reduces every layer's "
        "activations fwd+bwd (~4*B*T*D*28 bytes >> the 1.7B model's own "
        "gradients); expect collective/memory-bound",
        knobs=dict(grouped_gqa=False)),
    Experiment(
        "C1-fsdp-over-tp", "qwen3-1.7b", "train_4k",
        "napkin: adding data-sharding to the TP weights (ZeRO on top of TP) "
        "— prediction: ~4x collective reduction from replacing activation "
        "ARs with weight AGs",
        rules=FSDP, baseline="C0-baseline"),
    Experiment(
        "C2-fsdp+seq-attn", "qwen3-1.7b", "train_4k",
        "stack A1's sequence-parallel attention on top of C1 to also cut "
        "the memory term (probs sharded 16-way)",
        rules=FSDP, knobs=dict(seq_shard="model"),
        baseline="C1-fsdp-over-tp"),
    # The reference's C1 verdict (GSPMD): refuted, ZeRO on top of TP
    # leaving the activation all-reduces; revised to pure FSDP.
    Experiment(
        "C3-pure-fsdp", "qwen3-1.7b", "train_4k",
        "napkin: pure FSDP moves 3x params/step (2 AG + 1 RS ~ 20 GB "
        "global, ~80 MB/device) vs TP's ~150 GB/device activation ARs; "
        "expect the collective term to collapse by >10x",
        rules=PURE_FSDP, baseline="C0-baseline"),
    # Cell D (beyond the required three): deepseek-moe-16b x train_4k
    Experiment(
        "D0-baseline-cumsum-dispatch", "deepseek-moe-16b", "train_4k",
        "baseline: one-hot cumsum dispatch builds an [N*k, E] intermediate "
        "and O(N*E) prefix work per MoE layer at N=1M tokens; expect it to "
        "dominate all three terms",
        knobs=dict(dispatch="cumsum", grouped_gqa=False)),
    Experiment(
        "D1-sort-dispatch", "deepseek-moe-16b", "train_4k",
        "napkin: stable argsort dispatch is O(N*k log N*k) with no [N, E] "
        "intermediate; expert matmuls (top_k*N*3*2*d*de*cf ~ 1.3e14/layer) "
        "should become the dominant compute; expect >10x drop in the "
        "memory/compute terms",
        knobs=dict(dispatch="sort", grouped_gqa=False),
        baseline="D0-baseline-cumsum-dispatch"),
    # The reference's D1 verdict (GSPMD): 9.7x on compute, the collective
    # term untouched (the [E, C, d] buffer replicated and all-reduced);
    # revised to pin the buffer to the expert-parallel axis.  Both
    # packages' EP_CONSTRAINT_AXIS already defaults to "model", so D2 sets
    # what D1 has.
    Experiment(
        "D2-sort+ep-constraint", "deepseek-moe-16b", "train_4k",
        "napkin: constraining eb/out to P('model', ...) turns the buffer "
        "all-reduce (~30 GB/layer) into a dispatch all-to-all (~N*d*2 "
        "bytes ~ 4 GB/layer global); expect >5x on the collective term",
        knobs=dict(dispatch="sort", ep_axis="model", grouped_gqa=False),
        baseline="D1-sort-dispatch"),
)


def run_experiments(records, use_kernel=True):
    """The reference's twelve experiments (`EXPERIMENTS`), in its order,
    on one route; each against its baseline on the same route."""
    route = "kernel" if use_kernel else "plain"
    done, cell = {}, None
    for exp in EXPERIMENTS:
        if exp.name[0] != cell:
            cell = exp.name[0]
            print(f"=== {CELLS[cell]} ({route} route) ===")
        done[exp.name] = experiment(
            records, exp.name, exp.arch, exp.shape, exp.hypothesis,
            rules=exp.rules, baseline=done.get(exp.baseline),
            use_kernel=use_kernel, **exp.knobs)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=tuple(ROUTES), default="both",
                    help="plain: the reference's search; kernel: the "
                         "card's; both (the default)")
    ap.add_argument("--out", default="results/hillclimb_torch.json")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    records = []
    for use_kernel in ROUTES[args.route]:
        run_experiments(records, use_kernel)
    n_err = sum(r.get("status") == "error" for r in records)
    print(f"hillclimb: {len(records)} records, {n_err} failed, "
          f"{time.perf_counter() - t0:.1f}s")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    print("wrote", args.out)
    return records


if __name__ == "__main__":
    main()
