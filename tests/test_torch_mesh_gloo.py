"""A real mesh on the CPU: four gloo processes on `make_debug_mesh(2, 2)`,
the port's sharded train step and prefill (DTensor parameters placed by
the reference's rules, the kernels' wrappers on local shards,
`launch.layout`) against the one-process step of the same weights, and a
checkpoint saved on (2, 2) and restored onto (4, 1).

The same processes then run the mesh-only branches of `launch.layout` and
`kernels.ops` that the production mesh cells take (`CASES`), each a
scaled config's train step (loss and gradients) and prefill against the
one-process ones: query heads that do not divide the model axis (an
uneven split, rank 3 holding none, and K/V picked per query head), the
RG-LRU scan on channel shards, an expert-parallel MoE, FSDP with an
FSDP-sharded embedding table, the sequence-sharding knob (on the plain
route, where it acts; with uneven heads also on its chunked path, whose
scores `launch.layout.query_einsum` lays out), and the xLSTM cells on
each device's rows.  Each
case also shows that its branches ran (the kernels' and helpers' calls
on the mesh).  Saves of plain tensors under the group stay each
process's own: a rank-0-only save returns, and every rank's own save is
written.

Bounds: loss, gradients and the parameters after one AdamW step within
``TOL`` of the largest |value| of each (float32, or float64 for
`FLOAT64_CASES`; the sums run over the shards in another order), prefill
logits likewise; the restore bitwise.
"""
import dataclasses
import datetime

import numpy as np
import pytest
import torch

WORLD = 4
TOL = 1e-5
ARCH = "qwen3-1.7b"
ROWS, SEQ = 8, 16
# name: (arch, mesh (data, model), changes to the scaled config (one
# group of its block pattern), the kernels' route (use_kernel), the
# branches that must run on the mesh: the kernels' wrappers on local
# shards, `launch.layout` helpers, the sequence-sharding knob)
CASES = {
    "qwen3-uneven-heads": ("qwen3-1.7b", (1, 4),
                           {"n_heads": 6, "n_kv_heads": 2}, True,
                           ("flash", "kv_pick")),
    "recurrentgemma-channels": ("recurrentgemma-2b", (1, 4),
                                {"n_layers": 3}, True,
                                ("flash", "rg_lru", "kv_pick")),
    "deepseek-moe-expert-parallel": ("deepseek-moe-16b", (1, 4), {}, True,
                                     ("flash", "expert_scatter",
                                      "expert_gather")),
    "llama4-fsdp": ("llama4-maverick-400b-a17b", (2, 2), {"n_layers": 2},
                    True, ("flash", "expert_scatter", "fsdp_gather",
                           "kv_pick")),
    # the knob acts on the dense scores, so on the plain route
    "llama4-fsdp-seq-shard-plain": ("llama4-maverick-400b-a17b", (2, 2),
                                    {"n_layers": 2}, False,
                                    ("seq_shard", "expert_scatter",
                                     "fsdp_gather")),
    "xlstm-rows": ("xlstm-125m", (2, 2), {"n_layers": 4}, True,
                   ("on_rows",)),
    # the plain route's chunked scores with the queries sequence-sharded
    # (`CHUNKED_CASES` lowers the chunking threshold so that it chunks)
    "qwen1.5-uneven-seq-shard-chunked": ("qwen1.5-4b", (2, 2),
                                         {"n_heads": 3, "n_kv_heads": 3},
                                         False, ("seq_shard", "chunk",
                                                 "query_einsum")),
}
# name: (`attention._CHUNK_THRESHOLD`, `attention._Q_CHUNK`) for the case,
# both on one process and on the mesh: SEQ x SEQ scores chunked by 8
CHUNKED_CASES = {"qwen1.5-uneven-seq-shard-chunked": (64, 8)}
# Cases run in float64: the mLSTM's gate-bias gradient is ill-conditioned
# in float32 (the one-process float32 step itself lies further than 1e-5
# of its largest |value| from its float64 value), so a float32 comparison
# at 1e-5 would measure rounding, not the sharding.
FLOAT64_CASES = {"xlstm-rows"}


def _scaled():
    from repro_torch.configs import get_config

    return get_config(ARCH).scaled_down()


def _placed(model, cfg, mesh, kind):
    from repro_torch.launch import dryrun as dr
    from repro_torch.train import sharding

    rules = dr.default_rules_for(ARCH, kind, mesh)
    dr.place_module(model, sharding.param_pspecs(cfg, model, mesh, rules),
                    mesh, torch.device("cpu"), None)
    return rules


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()


class _Calls:
    """Counts of the mesh-only branches a step takes, by wrapping the
    module attributes that the port calls them through."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops
        from repro_torch.kernels import rg_lru as rl
        from repro_torch.launch import layout
        from repro_torch.models import attention

        self.n = {}
        self.on = False
        self._wrap(fa, "flash_attention", "flash")
        self._wrap(rl, "rg_lru", "rg_lru")
        for name in ("expert_scatter", "expert_gather", "on_rows"):
            self._wrap(layout, name, name)
        self._wrap(layout, "gathered", "fsdp_gather",
                   lambda w: any(p.is_shard() and name != "model"
                                 for name, p in zip(
                                     layout.mesh_names(w), w.placements))
                   if isinstance(w, layout.DTensor) else False)
        self._wrap(attention, "_seq_shard", "seq_shard",
                   lambda x, *rest: attention.SEQ_SHARD_AXIS is not None
                   and isinstance(x, layout.DTensor))
        self._wrap(attention, "_attend_dense", "chunk",
                   lambda cfg, q, *rest: isinstance(q, layout.DTensor)
                   and q.shape[1] == attention._Q_CHUNK)
        self._wrap(layout, "query_einsum", "query_einsum",
                   lambda eq, a, *rest: isinstance(a, layout.DTensor)
                   and layout.Shard(1) in a.placements)
        # a device's query heads that read K/V picked for them (the KV heads
        # do not divide the model axis)
        flash_on_shards = ops._flash_on_shards

        def on_shards(q, k, v, *rest):
            m = layout.model_split(q)
            if self.on and m > 1 and (q.shape[2] % m or k.shape[2] % m):
                self.n["kv_pick"] = self.n.get("kv_pick", 0) + 1
            return flash_on_shards(q, k, v, *rest)

        ops._flash_on_shards = on_shards

    def _wrap(self, module, attr, key, when=None):
        fn = getattr(module, attr)

        def counted(*args, **kwargs):
            if self.on and (when is None or when(*args)):
                self.n[key] = self.n.get(key, 0) + 1
            return fn(*args, **kwargs)

        setattr(module, attr, counted)


def _case(calls, name, arch, mesh_shape, changes, use_kernel):
    """One `CASES` entry: the one-process loss, gradients and prefill
    logits on rank 0, then the same on the mesh, every rank."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, attention
    from repro_torch.train import TrainHyper
    from repro_torch.train.train_step import init_train_state

    cfg = dataclasses.replace(get_config(arch).scaled_down(), **changes)
    hyper = TrainHyper(param_dtype="float32", use_kernel=use_kernel)
    dtype = torch.float64 if name in FLOAT64_CASES else torch.float32
    tokens = torch.randint(0, cfg.vocab, (ROWS, SEQ),
                           generator=torch.Generator().manual_seed(2))

    def fresh():
        state = init_train_state(cfg, hyper,
                                 torch.Generator().manual_seed(3), "cpu")
        state.model.to(dtype)
        return state

    def serving():
        model = api.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        model.to(dtype).requires_grad_(False)
        return model

    out = {}
    saved = attention._CHUNK_THRESHOLD, attention._Q_CHUNK
    attention._CHUNK_THRESHOLD, attention._Q_CHUNK = CHUNKED_CASES.get(
        name, saved)
    try:
        out.update(_one_and_mesh(calls, arch, mesh_shape, cfg, hyper,
                                 tokens, fresh, serving, use_kernel))
    finally:
        attention._CHUNK_THRESHOLD, attention._Q_CHUNK = saved
    return out


def _one_and_mesh(calls, arch, mesh_shape, cfg, hyper, tokens, fresh,
                  serving, use_kernel):
    """`_case`'s runs: the one-process loss, gradients and logits (rank
    0), then the mesh's."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import api
    from repro_torch.train import sharding
    from repro_torch.train.train_step import loss_fn

    out = {}
    if torch.distributed.get_rank() == 0:
        one = fresh()
        params = dict(one.model.named_parameters())
        loss, _ = loss_fn(cfg, one.model, {"tokens": tokens}, hyper)
        out["grads1"] = {n: g.numpy() for n, g in zip(
            params, torch.autograd.grad(loss, list(params.values())))}
        out["loss1"] = loss.detach().numpy()
        with torch.no_grad():
            out["logits1"] = api.prefill(cfg, serving(), {"tokens": tokens},
                                         SEQ + 8, use_kernel=use_kernel
                                         )[0].numpy()

    mesh = meshes.make_debug_mesh(*mesh_shape)
    calls.n, calls.on = {}, True
    with dr.production_knobs(arch, "train"):
        whole = dr.Cell(ROWS, None, (fresh(), {"tokens": tokens}))
        state, batch = dr.shard_cell(cfg, "train_4k", whole, mesh, None,
                                     "cpu").args
        params = dict(state.model.named_parameters())
        with implicit_replication():
            loss, _ = loss_fn(cfg, state.model, batch, hyper)
            grads = torch.autograd.grad(loss, list(params.values()))
    out["loss2"] = _full(loss)
    out["grads2"] = {n: _full(g) for n, g in zip(params, grads)}
    model = serving()
    rules = dr.default_rules_for(arch, "prefill", mesh)
    dr.place_module(model, sharding.param_pspecs(cfg, model, mesh, rules),
                    mesh, torch.device("cpu"), None)
    pspec = dr.batch_pspecs({"tokens": tokens}, mesh)
    with dr.production_knobs(arch, "prefill"), torch.no_grad(), \
            implicit_replication():
        logits, _ = api.prefill(
            cfg, model, {"tokens": dr.distribute(
                tokens, pspec["tokens"], mesh, torch.device("cpu"), None)},
            SEQ + 8, use_kernel=use_kernel)
    out["logits2"] = _full(logits)
    calls.on = False
    out["calls"] = dict(calls.n)
    return out


def _plain_saves(rank, ckpt_dir):
    """Saves of plain tensors under the group: rank 0's alone (no other
    rank saves; it must not wait for them), then every rank its own."""
    from repro_torch.checkpoint import CheckpointManager

    out = {}
    if rank == 0:
        mgr = CheckpointManager(f"{ckpt_dir}/rank0_only")
        mgr.save(1, {"x": torch.arange(4.0)}, blocking=True)
        mgr.wait()
        out["rank0_only"] = mgr.restore({"x": torch.zeros(4)})["x"].numpy()
    own = CheckpointManager(f"{ckpt_dir}/own_{rank}")
    own.save(1, {"r": torch.full((2,), float(rank))})
    own.wait()
    out["own"] = own.restore({"r": torch.zeros(2)})["r"].numpy()
    return out


def _run(rank, ckpt_dir):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import api
    from repro_torch.train import TrainHyper, make_train_step
    from repro_torch.train.train_step import init_train_state, loss_fn

    cfg = _scaled()
    hyper = TrainHyper(param_dtype="float32", use_kernel=True)
    tokens = torch.randint(0, cfg.vocab, (ROWS, SEQ),
                           generator=torch.Generator().manual_seed(1))

    def fresh():
        return init_train_state(cfg, hyper,
                                torch.Generator().manual_seed(0), "cpu")

    out = {}
    if rank == 0:       # the one-process step, kept by rank 0 alone
        one = fresh()
        params = dict(one.model.named_parameters())
        loss, _ = loss_fn(cfg, one.model, {"tokens": tokens}, hyper)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["loss1"] = loss.detach().numpy()
        out["grads1"] = {n: g.numpy() for n, g in zip(params, grads)}
        with torch.no_grad():
            logits, _ = api.prefill(cfg, one.model, {"tokens": tokens},
                                    SEQ + 8, use_kernel=True)
        out["logits1"] = logits.numpy()
        make_train_step(cfg, hyper)(one, {"tokens": tokens})
        out["after1"] = {n: p.detach().numpy()
                         for n, p in one.model.named_parameters()}

    # the (2, 2) mesh
    mesh = meshes.make_debug_mesh(2, 2)
    state, batch = dr.shard_cell(
        cfg, "train_4k", dr.Cell(ROWS, None, (fresh(), {"tokens": tokens})),
        mesh, None, "cpu").args
    params = dict(state.model.named_parameters())
    with implicit_replication():
        loss, _ = loss_fn(cfg, state.model, batch, hyper)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["loss2"] = _full(loss)
        out["grads2"] = {n: _full(g) for n, g in zip(params, grads)}
        make_train_step(cfg, hyper)(state, batch)
    out["after2"] = {n: _full(p) for n, p in state.model.named_parameters()}
    out["placements"] = {n: str(p.placements) for n, p in params.items()}

    serve = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    serve.requires_grad_(False)
    _placed(serve, cfg, mesh, "prefill")
    pspec = dr.batch_pspecs({"tokens": tokens}, mesh)
    with torch.no_grad(), implicit_replication():
        logits, _ = api.prefill(
            cfg, serve, {"tokens": dr.distribute(
                tokens, pspec["tokens"], mesh, torch.device("cpu"), None)},
            SEQ + 8, use_kernel=True)
    out["logits2"] = _full(logits)

    # save on (2, 2), restore onto (4, 1)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, {"model": state.model}, blocking=True)
    tall = meshes.make_mesh((4, 1), ("data", "model"))
    like = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    _placed(like, cfg, tall, "train")
    got = mgr.restore({"model": like})["model"]
    out["restored"] = {n: _full(p) for n, p in got.named_parameters()}
    out["restored_placements"] = {n: str(p.placements)
                                  for n, p in got.named_parameters()}

    saves = _plain_saves(rank, ckpt_dir)
    gathered = [None] * WORLD
    torch.distributed.all_gather_object(gathered, saves["own"])
    out["plain_saves"] = {"rank0_only": saves.get("rank0_only"),
                          "own": gathered}

    calls = _Calls()
    out["cases"] = {name: _case(calls, name, *case[:4])
                    for name, case in CASES.items()}
    return out


def _worker(rank, store, ckpt_dir, result):
    import torch.distributed as dist

    torch.manual_seed(0)
    # a rank waiting for others that never come fails in a minute
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = _run(rank, ckpt_dir)
        if rank == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh")
    result = str(tmp / "rank0.pt")
    mp.start_processes(_worker, args=(str(tmp / "store"), str(tmp / "ckpt"),
                                      result),
                       nprocs=WORLD, join=True, start_method="spawn")
    return torch.load(result, weights_only=False)


def _close(got, want, what):
    scale = float(np.max(np.abs(want))) or 1.0
    gap = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert got.shape == want.shape, what
    assert gap <= TOL * scale, f"{what}: {gap} > {TOL} * {scale}"


def test_sharded_loss_and_gradients_match_one_process(mesh_run):
    _close(mesh_run["loss2"], mesh_run["loss1"], "loss")
    assert set(mesh_run["grads2"]) == set(mesh_run["grads1"])
    for name, want in mesh_run["grads1"].items():
        _close(mesh_run["grads2"][name], want, name)
    # the mesh is really used: tensor- and data-parallel placements
    assert "Shard(dim=1)" in mesh_run["placements"]["layers.0.attn.wq"]


def test_sharded_train_step_matches_one_process(mesh_run):
    for name, want in mesh_run["after1"].items():
        _close(mesh_run["after2"][name], want, name)


def test_sharded_prefill_logits_match_one_process(mesh_run):
    _close(mesh_run["logits2"], mesh_run["logits1"], "prefill logits")


def test_checkpoint_from_2x2_restores_onto_4x1_bitwise(mesh_run):
    for name, want in mesh_run["after2"].items():
        got = mesh_run["restored"][name]
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    # onto the other mesh: the model axis has one device there
    assert "Shard(dim=1)" not in \
        mesh_run["restored_placements"]["layers.0.attn.wq"]


def test_plain_saves_under_a_group_stay_each_processs_own(mesh_run):
    saves = mesh_run["plain_saves"]
    assert np.array_equal(saves["rank0_only"], np.arange(4.0))
    for rank, got in enumerate(saves["own"]):
        assert np.array_equal(got, np.full((2,), float(rank))), rank


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_case_loss_and_gradients_match_one_process(mesh_run, case):
    got = mesh_run["cases"][case]
    _close(got["loss2"], got["loss1"], f"{case} loss")
    assert set(got["grads2"]) == set(got["grads1"])
    for name, want in got["grads1"].items():
        _close(got["grads2"][name], want, f"{case} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_case_prefill_logits_match_one_process(mesh_run, case):
    got = mesh_run["cases"][case]
    _close(got["logits2"], got["logits1"], f"{case} prefill logits")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_case_takes_its_sharded_branches(mesh_run, case):
    calls = mesh_run["cases"][case]["calls"]
    for key in CASES[case][4]:
        assert calls.get(key, 0) > 0, (key, calls)
