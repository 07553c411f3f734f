"""The port's hillclimb (`repro_torch.roofline.hillclimb`) and its two
knobs against the reference's (``repro/roofline/hillclimb.py``,
``models/attention.py::DECODE_GROUPED_GQA``, ``models/moe.py``'s
``DISPATCH_MODE`` and ``_positions_cumsum``).

The reference's ``roofline_cell`` builds a 256-device TPU mesh and is
never called: the harness parity patches ``roofline_cell`` in both
hillclimb modules with one stub, which records the knob values and the
rules it sees and returns records drawn from the experiment's name, so
that both ``main()``s run the same twelve experiments through the same
records.  The reference's ``hillclimb`` sets ``XLA_FLAGS`` when it is
imported; the fixture restores the variable.

Bounds: the cumsum ranks equal the reference's exactly and the port's
sort ranks exactly (the MoE's output bit for bit); the expanded-KV decode
as the reference's decode-parity test holds the grouped one (logits atol
1e-5 / rtol 1e-5, caches atol 5e-5 / rtol 1e-5).  The real count is the
full-size B cell on the meta 16 x 16 mesh, a few seconds.
"""
import dataclasses
import importlib
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ModuleNotFoundError:  # optional test extra; fall back to a fixed grid
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

from _torch_reference import load_reference, reference_modules

from repro_torch.configs import get_config
from repro_torch.models import api, attention, convert, moe
from repro_torch.roofline import hillclimb

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=5e-5, rtol=1e-5)
KNOBS = ("SEQ_SHARD_AXIS", "DECODE_GROUPED_GQA", "DISPATCH_MODE",
         "EP_CONSTRAINT_AXIS")


@pytest.fixture(scope="module")
def ref():
    """The reference's hillclimb, attention, MoE and model API."""
    jax.devices()           # the backend is up before XLA_FLAGS changes
    saved = os.environ.get("XLA_FLAGS")
    load_reference()
    try:
        with reference_modules():
            mods = {name.rsplit(".", 1)[1]: importlib.import_module(name)
                    for name in ("repro.roofline.hillclimb",
                                 "repro.models.attention", "repro.models.moe",
                                 "repro.models.api", "repro.configs",
                                 "repro.train.sharding")}
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mods


def _stub(attn, moe_mod, seen):
    """One `roofline_cell` for both packages: it notes what it was called
    under and returns a record drawn from the experiment's name."""
    def roofline_cell(arch, shape, rules=None, label="", mesh="16x16",
                      use_kernel=None):
        knobs = {k: getattr(attn if k in ("SEQ_SHARD_AXIS",
                                          "DECODE_GROUPED_GQA") else moe_mod,
                            k) for k in KNOBS}
        seen.append(dict(label=label, arch=arch, shape=shape, mesh=mesh,
                         use_kernel=use_kernel, knobs=knobs,
                         rules=None if rules is None
                         else dataclasses.asdict(rules)))
        rng = np.random.default_rng(zlib.crc32(label.encode()))
        terms = dict(zip(("compute", "memory", "collective"),
                         rng.uniform(1e-3, 10.0, 3).tolist()))
        rec = {"arch": arch, "shape": shape, "status": "ok", "label": label,
               "dominant": max(terms, key=terms.get),
               "roofline_bound_s": max(terms.values())}
        rec.update({f"t_{k}_s": v for k, v in terms.items()})
        return rec
    return roofline_cell


def _as_lists(d):
    return None if d is None else {
        k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def test_harness_runs_the_reference_experiments(ref, monkeypatch, tmp_path):
    """Both ``main()``s, through one stub: the same twelve experiments, in
    the same order, with the same cells, rules, knob values, hypotheses,
    labels and delta strings, on each of the port's two routes."""
    rseen, pseen = [], []
    monkeypatch.setattr(ref["hillclimb"], "roofline_cell",
                        _stub(ref["attention"], ref["moe"], rseen))
    monkeypatch.setattr(hillclimb, "roofline_cell",
                        _stub(attention, moe, pseen))
    monkeypatch.chdir(tmp_path)
    with reference_modules():
        ref["hillclimb"].main()
    with open(tmp_path / "results" / "hillclimb.json") as f:
        want = __import__("json").load(f)
    got = hillclimb.main(["--out", str(tmp_path / "port.json")])
    assert len(want) == 12 and len(got) == 24
    assert [s["use_kernel"] for s in pseen] == [False] * 12 + [True] * 12
    for route in range(2):
        mine = got[12 * route: 12 * (route + 1)]
        seen = pseen[12 * route: 12 * (route + 1)]
        for w, g, rs, ps in zip(want, mine, rseen, seen):
            assert g == w, w["label"]
            assert ps["mesh"] == "16x16"
            for key in ("label", "arch", "shape", "knobs"):
                assert ps[key] == rs[key], (w["label"], key)
            assert _as_lists(ps["rules"]) == _as_lists(rs["rules"]), \
                w["label"]
    assert sum("dominant_term_delta" in r for r in got) == 2 * 8
    # the knobs come back as they were
    assert {k: getattr(attention if k in KNOBS[:2] else moe, k)
            for k in KNOBS} == {"SEQ_SHARD_AXIS": None,
                                "DECODE_GROUPED_GQA": True,
                                "DISPATCH_MODE": "sort",
                                "EP_CONSTRAINT_AXIS": "model"}


def test_experiment_restores_the_knobs_when_the_count_raises(monkeypatch):
    inside = []

    def boom(*args, **kwargs):
        inside.append((attention.SEQ_SHARD_AXIS, attention.DECODE_GROUPED_GQA,
                       moe.DISPATCH_MODE, moe.EP_CONSTRAINT_AXIS))
        raise RuntimeError("count failed")

    monkeypatch.setattr(hillclimb, "roofline_cell", boom)
    before = (attention.SEQ_SHARD_AXIS, attention.DECODE_GROUPED_GQA,
              moe.DISPATCH_MODE, moe.EP_CONSTRAINT_AXIS)
    with pytest.raises(RuntimeError, match="count failed"):
        hillclimb.experiment([], "x", "qwen3-1.7b", "train_4k", "h",
                             seq_shard="model", grouped_gqa=False,
                             dispatch="cumsum", ep_axis="data")
    assert inside == [("model", False, "cumsum", "data")]
    assert (attention.SEQ_SHARD_AXIS, attention.DECODE_GROUPED_GQA,
            moe.DISPATCH_MODE, moe.EP_CONSTRAINT_AXIS) == before
    # a knob given as None is left as it is, as in the reference
    with pytest.raises(RuntimeError):
        hillclimb.experiment([], "y", "qwen3-1.7b", "train_4k", "h")
    assert inside[1] == before
    assert (attention.SEQ_SHARD_AXIS, attention.DECODE_GROUPED_GQA,
            moe.DISPATCH_MODE, moe.EP_CONSTRAINT_AXIS) == before


def _ref_moe():
    """The reference's MoE module (hypothesis's fallback `given` takes no
    fixtures)."""
    load_reference()
    with reference_modules():
        return importlib.import_module("repro.models.moe")


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 300),
       experts=st.integers(1, 64))
def test_positions_cumsum_equals_the_reference(seed, n, experts):
    ref_moe = _ref_moe()
    ids = np.random.default_rng(seed).integers(0, experts, n).astype(np.int32)
    want = np.asarray(ref_moe._positions_cumsum(jnp.asarray(ids), experts))
    got = moe._positions_cumsum(torch.from_numpy(ids).long(), experts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    sort = moe._positions_sort(torch.from_numpy(ids).long(), experts)
    np.testing.assert_array_equal(sort.numpy(), want)


def test_cumsum_dispatch_is_bitwise_the_sort_dispatch(monkeypatch):
    # a capacity this small drops entries, so the ranks decide the result
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").scaled_down(),
                              capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(cfg, gen, "cpu")
    x = torch.randn((2, 48, cfg.d_model), generator=gen)
    monkeypatch.setattr(moe, "DISPATCH_MODE", "sort")
    want = moe.moe_forward(params, cfg, x)
    monkeypatch.setattr(moe, "DISPATCH_MODE", "cumsum")
    got = moe.moe_forward(params, cfg, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat_e = moe.route(params, cfg, x.reshape(-1, cfg.d_model))[2].reshape(-1)
    assert int(moe.dispatch(flat_e, cfg, moe.expert_capacity(96, cfg))[1]
               .logical_not().sum()) > 0


# arch -> (scaled_down overrides, prompt length): a full cache (qwen3's
# grouped KV heads) and both caches (gemma2's local layers ring)
DECODE_CASES = {"qwen3-1.7b": ({}, 24), "gemma2-27b": (dict(window=8), 24)}


@pytest.mark.parametrize("arch", sorted(DECODE_CASES))
def test_expanded_kv_decode_matches_the_reference(ref, monkeypatch, arch):
    over, prompt = DECODE_CASES[arch]
    rapi, rattn = ref["api"], ref["attention"]
    rcfg = ref["configs"].get_config(arch).scaled_down(**over)
    pcfg = get_config(arch).scaled_down(**over)
    assert pcfg.n_heads != pcfg.n_kv_heads
    with reference_modules():
        params = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    model = convert.params_from_reference(pcfg, jax.device_get(params),
                                          device="cpu")
    rng = np.random.default_rng(sum(map(ord, arch)))
    toks = rng.integers(0, pcfg.vocab, (2, prompt)).astype(np.int32)
    steps = rng.integers(0, pcfg.vocab, (4, 2)).astype(np.int32)
    monkeypatch.setattr(rattn, "DECODE_GROUPED_GQA", False)
    monkeypatch.setattr(attention, "DECODE_GROUPED_GQA", False)
    grouped = []
    monkeypatch.setattr(attention, "_grouped_decode_attend",
                        lambda *a: grouped.append(1))
    with reference_modules():
        _, rcache = rapi.prefill(rcfg, params, {"tokens": jnp.asarray(toks)},
                                 prompt + 8)
        with torch.no_grad():
            _, pcache = api.prefill(pcfg, model,
                                    {"tokens": torch.from_numpy(toks).long()},
                                    prompt + 8)
        for step, tok in enumerate(steps):
            index = prompt + step
            rlogits, rcache = rapi.decode_step(rcfg, params, rcache,
                                               jnp.asarray(tok),
                                               jnp.asarray(index, jnp.int32))
            with torch.no_grad():
                plogits, pcache = api.decode_step(
                    pcfg, model, pcache, torch.from_numpy(tok).long(), index)
            np.testing.assert_allclose(plogits.numpy(), np.asarray(rlogits),
                                       err_msg=f"step {step}", **LOGIT_TOL)
    assert not grouped
    want = _leaves(jax.device_get(rcache))
    got = _leaves(convert.cache_to_reference_layout(pcfg, pcache))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        if path[-1] == "pos":
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
        else:
            np.testing.assert_allclose(g, np.asarray(w), err_msg=str(path),
                                       **CACHE_TOL)
    kinds = {p[-1] for p, _ in want}
    assert kinds == ({"k", "v", "pos"} if arch == "gemma2-27b"
                     else {"k", "v"})


def _leaves(tree):
    """(path, leaf) pairs of a nested dict, by sorted key."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += [((k,) + p, x) for p, x in _leaves(v)]
        else:
            out.append(((k,), v))
    return out


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
def test_b_cell_counts_at_full_size_on_the_mesh(use_kernel):
    """B0 and B1 (qwen3-1.7b decode_32k), full size, rank 0 of the meta
    16 x 16 mesh: both count, under the reference roofline's rules and
    the experiments' knobs, and B1's deltas are taken against B0."""
    records = []
    b0 = hillclimb.experiment(records, "B0-baseline", "qwen3-1.7b",
                              "decode_32k", "h0", grouped_gqa=False,
                              use_kernel=use_kernel)
    b1 = hillclimb.experiment(records, "B1-grouped-gqa", "qwen3-1.7b",
                              "decode_32k", "h1", grouped_gqa=True,
                              baseline=b0, use_kernel=use_kernel)
    for rec, grouped in ((b0, False), (b1, True)):
        assert rec["status"] == "ok", rec.get("error")
        assert rec["mesh"] == "16x16"
        assert rec["route"] == ("kernel" if use_kernel else "plain")
        assert rec["knobs"]["DECODE_GROUPED_GQA"] is grouped
        assert rec["rules"] == {"of": "reference", "fsdp": False,
                                "data_axes": ["data"],
                                "tensor_parallel": True,
                                "decode_cache_seq_shard": False}
        assert rec["fits"] and rec["coll_bytes_per_device"] > 0
    assert b0["label"] == "B0-baseline" and b1["hypothesis"] == "h1"
    dom = b0["dominant"]
    assert b1["dominant_term_delta"] == hillclimb._delta(b0, b1,
                                                         f"t_{dom}_s")
    assert b1["bound_delta"] == hillclimb._delta(b0, b1, "roofline_bound_s")
    assert "dominant_term_delta" not in b0
