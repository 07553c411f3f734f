"""The device mesh on the CPU: the sharding rules (`repro_torch.train.
sharding`) against the reference's ``repro/train/sharding.py``, exactly,
and the per-device count of the dry run on a fake process group
(`repro_torch.launch.mesh`, `repro_torch.launch.dryrun`,
`repro_torch.roofline.collectives`).

The reference's ``param_pspecs`` and ``auto_pspec`` read a mesh's
``axis_names`` and ``devices.shape`` only, so they get a stand-in with
``devices = np.empty(shape)``; its parameter shapes come from
``jax.eval_shape`` of its own init, full size, nothing allocated.  A
spec entry that is a one-name tuple equals the bare name (jax's
``PartitionSpec`` normalizes it so).
"""
import dataclasses
import importlib
import math
import os

import numpy as np
import pytest
import torch

from _torch_reference import load_reference, reference_modules

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_skip_reason
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as meshes
from repro_torch.models import api, convert
from repro_torch.roofline import analysis
from repro_torch.train import sharding

MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(scope="module")
def ref():
    """The reference's sharding rules, dry run and model API."""
    import jax

    jax.devices()           # the backend is up before XLA_FLAGS changes
    saved = os.environ.get("XLA_FLAGS")
    load_reference()
    try:
        with reference_modules():
            mods = {name: importlib.import_module(name) for name in (
                "repro.train.sharding", "repro.launch.dryrun",
                "repro.models.api", "repro.configs")}
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mods


class _StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, multi_pod):
        shape = meshes.production_shape(multi_pod)
        self.axis_names = shape.axis_names
        self.devices = np.empty(shape.shape)


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


_REF_PARAMS: dict = {}


def _ref_params(ref, arch):
    """The reference's config and parameter shapes (``jax.eval_shape`` of
    its init), once an architecture."""
    import jax
    import jax.numpy as jnp

    if arch not in _REF_PARAMS:
        cfg = ref["repro.configs"].get_config(arch)
        _REF_PARAMS[arch] = cfg, jax.eval_shape(
            lambda k: ref["repro.models.api"].init_params(cfg, k),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return _REF_PARAMS[arch]


def _ref_leaf(tree, cfg, name):
    """The reference leaf of the port's parameter ``name``, and whether it
    is stacked (a leading layer axis)."""
    parts = name.split(".")
    if parts[0] in ("enc", "dec") and cfg.enc_layers:
        path, stacked = [parts[0]] + parts[2:], True
    elif parts[0] == "layers":
        section, key, g = convert._layer_slots(cfg)[int(parts[1])]
        path, stacked = [section, key] + parts[2:], g is not None
    else:
        path, stacked = parts, False
    for key in path:
        tree = tree[key]
    return tree, stacked


def _rule_pairs(ref, mesh):
    """(port rules, reference rules) for the default, FSDP and pure-FSDP
    (no tensor parallelism) cases on ``mesh``."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    out = [(None, None)]
    for kw in (dict(fsdp=True, data_axes=dp),
               dict(fsdp=False, data_axes=dp),
               dict(tensor_parallel=False, fsdp=True,
                    data_axes=dp + ("model",))):
        out.append((sharding.ShardingRules(**kw),
                    ref["repro.train.sharding"].ShardingRules(**kw)))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_the_reference(ref, arch):
    """Every parameter's spec, both meshes, FSDP on and off, and without
    tensor parallelism, full size."""
    from jax.sharding import PartitionSpec as P
    import jax

    rcfg, shapes = _ref_params(ref, arch)
    cfg = get_config(arch)
    model = api.init_params(cfg, None, "meta")
    named = dict(model.named_parameters())
    n = 0
    for multi in MESHES.values():
        stand_in = _StandIn(multi)
        mesh = meshes.production_shape(multi)
        for mine, theirs in _rule_pairs(ref, stand_in):
            want = ref["repro.train.sharding"].param_pspecs(
                rcfg, shapes, stand_in, theirs)
            got = sharding.param_pspecs(cfg, model, mesh, mine)
            assert set(got) == set(named)
            for name, spec in got.items():
                leaf, stacked = _ref_leaf(want, rcfg, name)
                assert isinstance(leaf, P), name
                expect = _norm(tuple(leaf))
                assert _norm(((None,) if stacked else ()) + spec) == \
                    expect, (name, spec, expect)
                n += 1
    # every reference leaf was reached by some port parameter
    assert n >= len(jax.tree.leaves(shapes)) * 2 * 4


def test_default_rules_and_batch_specs_equal_the_reference(ref):
    rdr = ref["repro.launch.dryrun"]
    rsh = ref["repro.train.sharding"]
    assert dr.FSDP_TRAIN_ARCHS == rdr.FSDP_TRAIN_ARCHS
    assert dr.FSDP_SERVE_ARCHS == rdr.FSDP_SERVE_ARCHS
    assert dr.SEQ_SHARD_ARCHS == rdr.SEQ_SHARD_ARCHS
    for multi in MESHES.values():
        stand_in = _StandIn(multi)
        mesh = meshes.production_shape(multi)
        for arch in ARCH_IDS:
            rcfg = ref["repro.configs"].get_config(arch)
            cfg = get_config(arch)
            for name, shape in SHAPES.items():
                mine = dr.default_rules_for(arch, shape.kind, mesh)
                theirs = rdr.default_rules_for(arch, shape.kind, stand_in)
                assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
                assert _norm(sharding.batch_pspec(mine)) == \
                    _norm(tuple(rsh.batch_pspec(theirs)))
                if shape_skip_reason(cfg, name):
                    continue
                mbs = {1}
                if shape.kind == "train":
                    mbs.add(dr.train_hyper_for(arch).microbatches)
                for mb in sorted(mbs):
                    _, want = rdr._batch_specs(
                        rcfg, shape.global_batch, shape.seq_len, stand_in,
                        microbatches=mb,
                        rules=theirs if shape.kind == "train" else None)
                    batch = dr._batch_specs(cfg, shape.global_batch,
                                            shape.seq_len, mb, "meta")
                    got = dr.batch_pspecs(
                        batch, mesh, mb,
                        mine if shape.kind == "train" else None)
                    assert set(got) == set(want)
                    for key in got:
                        assert _norm(got[key]) == _norm(tuple(want[key])), (
                            arch, name, key)
    assert sharding.batch_pspec() == (("pod", "data"),)


def test_auto_pspec_on_the_cache_shapes_equals_the_reference(ref):
    """`auto_pspec` on every decode cell's cache leaf (the reference's
    stacked group leaves with their layer axis), and the port's cache
    spec equal to it where the sequence is not sharded."""
    import jax
    import jax.numpy as jnp

    rsh = ref["repro.train.sharding"]
    for multi in MESHES.values():
        stand_in = _StandIn(multi)
        mesh = meshes.production_shape(multi)
        for arch in ARCH_IDS:
            rcfg = ref["repro.configs"].get_config(arch)
            cfg = get_config(arch)
            for name in ("decode_32k", "long_500k"):
                shape = SHAPES[name]
                if shape_skip_reason(cfg, name):
                    continue
                b, s = shape.global_batch, shape.seq_len
                tree = jax.eval_shape(lambda: ref["repro.models.api"]
                                      .init_cache(rcfg, b, s, jnp.bfloat16))
                leaves = jax.tree_util.tree_leaves_with_path(tree)
                for rules in (None, dr.default_rules_for(arch, "decode",
                                                          mesh)):
                    rrules = None if rules is None else rsh.ShardingRules(
                        **dataclasses.asdict(rules))
                    for path, leaf in leaves:
                        keys = [str(getattr(e, "key", "")) for e in path]
                        stacked = any(k in ("groups", "enc", "dec", "self",
                                            "cross") for k in keys)
                        want = _norm(tuple(rsh.auto_pspec(
                            leaf.shape, stand_in, rrules, stacked=stacked)))
                        got = sharding.auto_pspec(leaf.shape, mesh, rules,
                                                  stacked=stacked)
                        assert _norm(got) == want, (arch, keys)
                        if stacked and not cfg.enc_layers:
                            # the port keeps one tensor per layer
                            one = sharding.auto_pspec(leaf.shape[1:], mesh,
                                                      rules)
                            assert _norm((None,) + one) == want
                cache = api.init_cache(cfg, b, s, torch.bfloat16, "meta")
                specs = dr.cache_pspecs(cfg, cache, mesh, dr.default_rules_for(
                    arch, "decode", mesh))
                for key, part in specs.items():
                    for leaf_name, spec in part.items():
                        assert len(spec) == cache[key][leaf_name].ndim


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = meshes.production_shape(True)
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    assert sharding.local_shape((64, 10, 48), (("pod", "data"), None,
                                               "model"), mesh) == (2, 10, 3)
    # uneven: chunks of ceil(n / size), the last ones shorter or empty
    assert sharding.local_shape((40,), ("model",),
                                meshes.production_shape(False),
                                (0, 15)) == (0,)
    assert sharding.local_shape((40,), ("model",),
                                meshes.production_shape(False),
                                (0, 13)) == (1,)


# ---------------------------------------------------------------------------
# The per-device count on a fake group of 256 (rank 0's shards on meta)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meta_mesh():
    """The 16x16 mesh on a fake process group, meta shards; the group is
    taken down after the module."""
    import torch.distributed as dist

    yield meshes.make_production_mesh(False, "meta")
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_bytes(shape, spec, mesh, width) -> int:
    return math.prod(sharding.local_shape(shape, spec, mesh)) * width


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_are_the_reference_specs_local_shards(ref, meta_mesh,
                                                             arch):
    """A train cell's arguments on one device: each parameter's local
    shard by the reference's spec, in the train hyper's dtype, twice more
    for the AdamW moments in their dtype, the batch's by the reference's
    batch spec, and two int32 step counts."""
    rcfg, shapes = _ref_params(ref, arch)
    stand_in = _StandIn(False)
    mesh = meshes.production_shape(False)
    rules = dr.default_rules_for(arch, "train", mesh)
    rrules = ref["repro.train.sharding"].ShardingRules(
        **dataclasses.asdict(rules))
    want_specs = ref["repro.train.sharding"].param_pspecs(
        rcfg, shapes, stand_in, rrules)
    import jax

    hyper = dr.train_hyper_for(arch)
    width = {"bfloat16": 2, "float32": 4}
    per_param = width[hyper.param_dtype] + 2 * width[hyper.opt.state_dtype]
    want = 0
    for leaf, spec in zip(jax.tree.leaves(shapes),
                          jax.tree.leaves(want_specs, is_leaf=lambda x: (
                              type(x).__name__ == "PartitionSpec"))):
        want += _local_bytes(leaf.shape, tuple(spec), mesh, per_param)
    shape = SHAPES["train_4k"]
    _, bspec = ref["repro.launch.dryrun"]._batch_specs(
        rcfg, shape.global_batch, shape.seq_len, stand_in, microbatches=1,
        rules=rrules)
    batch = dr._batch_specs(get_config(arch), shape.global_batch,
                            shape.seq_len, 1, "meta")
    for key, t in batch.items():
        want += _local_bytes(t.shape, tuple(bspec[key]), mesh,
                             t.element_size())
    want += 2 * 4
    cell = dr.build_cell(get_config(arch), "train_4k", microbatches=1,
                         mesh=meta_mesh)
    assert dr.storage_bytes(cell.args) == want


def test_pure_data_parallel_count_is_the_one_card_count(meta_mesh):
    """With no tensor parallelism and no FSDP (every parameter replicated,
    the batch over all 256 devices), a train cell's FLOPs per device are
    the one-card count at global_batch / 256 rows, and its all-reduce
    moves the gradients (each once, over the whole mesh)."""
    cfg = get_config("olmo-1b").scaled_down()
    rules = sharding.ShardingRules(tensor_parallel=False, fsdp=False,
                                   data_axes=("data", "model"))
    got = dr._count(cfg, "train_4k", rows=256, seq_len=32, mesh=meta_mesh,
                    rules=rules)
    one = dr._count(cfg, "train_4k", rows=1, seq_len=32)
    assert got["flops"] == one["flops"]
    model = api.init_params(cfg, None, "meta")
    grads = sum(p.numel() for p in model.parameters()) * 2      # bf16
    colls = got["collectives"]
    assert set(colls["count_by_kind"]) == {"all-reduce"}
    assert colls["count_by_kind"]["all-reduce"] == \
        len(list(model.parameters()))
    assert colls["bytes_by_kind"]["all-reduce"] == grads


def test_collective_counter_names_and_sizes(meta_mesh):
    """Each collective a redistribute issues, under the reference's kind
    names, its result bytes per device (the gathered tensor of an
    all-gather, the scattered shard of a reduce-scatter)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.roofline.collectives import CollectiveCounter

    def dt(local, placements, shape):
        return DTensor.from_local(torch.empty(local, device="meta"),
                                  meta_mesh, placements, run_check=False,
                                  shape=shape, stride=(shape[1], 1))

    with CollectiveCounter() as c:
        dt((16, 64), [Shard(0), Replicate()], (256, 64)).redistribute(
            meta_mesh, [Replicate(), Replicate()])
        dt((256, 64), [Partial(), Replicate()], (256, 64)).redistribute(
            meta_mesh, [Replicate(), Replicate()])
        dt((256, 64), [Replicate(), Partial()], (256, 64)).redistribute(
            meta_mesh, [Replicate(), Shard(0)])
        dt((16, 64), [Shard(0), Replicate()], (256, 64)).redistribute(
            meta_mesh, [Shard(1), Replicate()])
    got = c.result()
    assert got["count_by_kind"] == {"all-gather": 1, "all-reduce": 1,
                                    "reduce-scatter": 1, "all-to-all": 1}
    assert got["bytes_by_kind"] == {"all-gather": 256 * 64 * 4.0,
                                    "all-reduce": 256 * 64 * 4.0,
                                    "reduce-scatter": 16 * 64 * 4.0,
                                    "all-to-all": 256 * 4 * 4.0}
    assert got["total_bytes"] == sum(got["bytes_by_kind"].values())
    assert got["unknown_dtypes"] == []


def test_roofline_extrapolation_carries_the_collectives(meta_mesh):
    """The L=1 / L=2 extrapolation of a mesh count (the reference's
    ``_extrapolate``, collective bytes included) equals the count at three
    groups."""
    cfg = get_config("qwen3-1.7b").scaled_down()
    got = [analysis._measure(analysis._reduced_cfg(cfg, g), "train_4k",
                             rows=16, seq_len=32, mesh=meta_mesh)
           for g in (1, 2, 3)]
    full = analysis._extrapolate(got[0], got[1], 3)
    for key in ("flops", "bytes", "coll_bytes"):
        assert full[key] == got[2][key], key
    assert got[2]["coll_bytes"] > 0
    assert full["coll_by_kind"] == pytest.approx(got[2]["coll_by_kind"])


def test_roofline_terms_on_the_mesh():
    from repro_torch.roofline.hw import H100

    cfg = get_config("qwen3-1.7b")
    rec = {"dtype": "bfloat16", "flops_per_device": 2e12,
           "bytes_accessed_per_device": 1e10,
           "collectives": {"total_bytes": 5e9,
                           "bytes_by_kind": {"all-reduce": 5e9}}}
    terms = analysis.roofline_terms(rec, cfg, SHAPES["train_4k"], H100, 256)
    assert terms["t_collective_s"] == 5e9 / H100.ici_link_bw == 0.1
    assert terms["dominant"] == "collective"
    assert terms["coll_bytes_per_device"] == 5e9
    assert terms["coll_by_kind"] == {"all-reduce": 5e9}
    assert terms["useful_flops_ratio"] == pytest.approx(
        analysis.model_flops(cfg, SHAPES["train_4k"]) / (2e12 * 256))


def test_xlstm_mesh_cell_is_counted_at_its_own_length(meta_mesh):
    """On a mesh an xLSTM cell is counted directly at its length, not
    solved from short lengths (no count is a polynomial in the length
    there): its FLOPs, bytes, peak and collectives are the direct
    count's."""
    cfg = dataclasses.replace(get_config("xlstm-125m").scaled_down(),
                              n_layers=2, block_pattern=("mlstm", "slstm"))
    assert dr.uses_poly(cfg, "prefill_32k")
    got = dr._count(cfg, "prefill_32k", rows=256, seq_len=48, mesh=meta_mesh)
    want = dr.count_cell(dr.build_cell(cfg, "prefill_32k", 256, seq_len=48,
                                       mesh=meta_mesh))
    assert "poly_lengths" not in got
    for key in ("flops", "bytes", "peak_bytes", "collectives"):
        assert got[key] == want[key], key
    assert got["collectives"]["total_bytes"] > 0


def test_mesh_knobs_leave_plain_tensors_alone():
    from repro_torch.launch import layout
    from repro_torch.models import attention, moe

    x = torch.randn(2, 8, 4, 16)
    prev = attention.SEQ_SHARD_AXIS
    attention.SEQ_SHARD_AXIS = "model"
    try:
        assert attention._seq_shard(x) is x
    finally:
        attention.SEQ_SHARD_AXIS = prev
    assert moe._ep_constrain(x, ("E", None, None, None)) is x
    assert layout.constrain(x, ("model", None, None, None)) is x
    table, ids = torch.randn(10, 3), torch.tensor([[1, 9], [0, 4]])
    assert torch.equal(layout.lookup(table, ids), table[ids])
    logits = torch.randn(3, 7)
    assert torch.equal(layout.argmax_last(logits),
                       torch.argmax(logits, dim=-1))


def test_plain_route_counts_the_chunked_seq_sharded_prefill(meta_mesh,
                                                             monkeypatch):
    """qwen1.5-4b prefill_32k, full size, on the plain route with the
    production rules and knobs: its 20 heads do not split over the model
    axis, so the queries are sequence-sharded, and each of the 32 query
    chunks' scores and probabilities are laid out by hand
    (`layout.query_einsum`), where DTensor's own einsum could not view
    them back."""
    from repro_torch.launch import layout

    by_hand = []
    einsum = layout.query_einsum

    def spy(equation, a, b, shape):
        if isinstance(a, layout.DTensor) and \
                layout.Shard(1) in a.placements:
            by_hand.append(shape[1])
        return einsum(equation, a, b, shape)

    monkeypatch.setattr(layout, "query_einsum", spy)
    cfg = get_config("qwen1.5-4b")
    got = dr.count_on_mesh("qwen1.5-4b", "prefill_32k", meta_mesh,
                           use_kernel=False)
    assert len(by_hand) == 2 * 32 * cfg.n_layers
    assert set(by_hand) == {1024}
    assert got["flops"] > 0 and got["collectives"]["total_bytes"] > 0
    assert got["planned_launches"]["flash_attention"] == 0


def test_roofline_on_the_mesh_counts_under_the_reference_rules(monkeypatch):
    """`roofline_cell` on 16x16 builds its cell as the reference's
    roofline does: ``ShardingRules(data_axes=("data",))``, the knobs as
    they stand (no production knobs: ``SEQ_SHARD_AXIS`` stays None even
    for a `SEQ_SHARD_ARCHS` cell), one microbatch; and its record says
    so.  The spy stops the count after the cell is built."""
    from repro_torch.models import attention

    seen = []

    def spy(cfg, shape_name, rows=None, device="meta", use_kernel=True,
            seq_len=None, microbatches=None, seed=0, mesh=None, rules=None):
        seen.append(dict(arch=cfg.name, rules=rules, mesh=mesh,
                         microbatches=microbatches, use_kernel=use_kernel,
                         seq_shard=attention.SEQ_SHARD_AXIS))
        raise RuntimeError("stop after the build")

    monkeypatch.setattr(dr, "build_cell", spy)
    rec = analysis.roofline_cell("qwen1.5-4b", "train_4k", mesh="16x16",
                                 verbose=False, label="A0", use_kernel=False)
    assert rec["status"] == "error" and "stop after" in rec["error"]
    assert rec["label"] == "A0"
    (got,) = seen
    assert got["rules"] == sharding.ShardingRules(data_axes=("data",))
    assert got["seq_shard"] is None and got["microbatches"] == 1
    assert got["use_kernel"] is False
    assert meshes.axis_sizes(got["mesh"]) == {"data": 16, "model": 16}
    # the dry run's own mesh count keeps the production rules and knobs
    seen.clear()
    rec = dr.run_mesh_cell("qwen1.5-4b", "train_4k", False, verbose=False)
    (got,) = seen
    assert got["rules"] == dr.default_rules_for(
        "qwen1.5-4b", "train", got["mesh"])
    assert got["seq_shard"] == "model"
