"""The port's training substrate on the CPU: the data pipeline against the
JAX reference (the same numpy draws, so the tokens are equal), the
checkpoint manager's on-disk contract, resume, and the training launcher;
with the reference's own substrate properties (``tests/test_substrate.py``:
checkpoint round trip, keep-N, ``.tmp`` never counted, restore elsewhere,
resume identical, deterministic host shards, a tiny model learns).
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_reference import load_reference

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_batch_iterator, synthetic_batch
from repro_torch.launch import train as launch_train
from repro_torch.train import TrainHyper, init_train_state, make_train_step


def _rdata():
    return load_reference()["repro.data"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=32, global_batch=8, host_id=0, n_hosts=2),
    dict(vocab=100, seq_len=32, global_batch=8, host_id=1, n_hosts=2),
    dict(vocab=512, seq_len=48, global_batch=3, seed=7),
    dict(vocab=512, seq_len=5, global_batch=2, seed=1, vision_tokens=4,
         vit_dim=6),
], ids=str)
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_batch_equals_reference(kw, step):
    rd = _rdata()
    want = rd.synthetic_batch(rd.DataConfig(**kw), step)
    got = synthetic_batch(DataConfig(**kw), step, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == (torch.int32 if k == "tokens"
                                else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_data_pipeline_deterministic_and_host_sharded():
    dc0 = DataConfig(vocab=100, seq_len=32, global_batch=8, host_id=0,
                     n_hosts=2)
    dc1 = DataConfig(vocab=100, seq_len=32, global_batch=8, host_id=1,
                     n_hosts=2)
    a = synthetic_batch(dc0, 7, device="cpu")["tokens"]
    b = synthetic_batch(dc0, 7, device="cpu")["tokens"]
    c = synthetic_batch(dc1, 7, device="cpu")["tokens"]
    assert torch.equal(a, b)
    assert a.shape == (4, 32)                        # host shard
    assert not torch.equal(a, c)


def test_batch_iterator_walks_the_steps_from_its_start():
    dc = DataConfig(vocab=64, seq_len=8, global_batch=2, seed=3)
    it = make_batch_iterator(dc, start_step=5, device="cpu")
    for step in (5, 6, 7, 8):
        assert torch.equal(next(it)["tokens"],
                           synthetic_batch(dc, step, device="cpu")["tokens"])


def test_synthetic_batch_needs_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_batch(DataConfig(vocab=8, seq_len=4, global_batch=1), 0)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)},
            "h": torch.arange(5.0).to(torch.bfloat16),
            "i": torch.tensor(7, dtype=torch.int32), "none": None}
    mgr.save(10, tree, blocking=True)
    like = {k: (None if v is None else
                {"c": torch.zeros(4)} if isinstance(v, dict) else
                torch.zeros_like(v)) for k, v in tree.items()}
    out = mgr.restore(like)
    for k in ("a", "h", "i"):
        assert out[k].dtype == tree[k].dtype and torch.equal(out[k], tree[k])
    assert torch.equal(out["b"]["c"], tree["b"]["c"]) and out["none"] is None
    with open(tmp_path / "step_10" / "manifest.json") as f:
        manifest = json.load(f)
    assert [r["file"] for r in manifest["leaves"]] == \
        ["a.npy", "b.c.npy", "h.npy", "i.npy"]
    assert manifest["leaves"][2]["dtype"] == "bfloat16"


def test_checkpoint_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"x": torch.ones(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.latest_step() == 4
    dirs = sorted(os.listdir(tmp_path))
    assert "step_1" not in dirs and "step_2" not in dirs
    assert "step_3" in dirs and "step_4" in dirs


@pytest.mark.parametrize("name", ["step_9.tmp", "step_11"])
def test_checkpoint_atomicity_no_partial(tmp_path, name):
    """A ``.tmp`` directory, or one without its manifest, never counts."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), name))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(1)})


def test_checkpoint_async_save_copies_before_returning(tmp_path):
    """The background writer saves the values at the time of the call,
    though the caller goes on updating the tensors in place."""
    mgr = CheckpointManager(str(tmp_path))
    x = torch.ones(1000)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore({"x": torch.zeros(1000)})["x"],
                       torch.ones(1000))


def test_checkpoint_restore_onto_a_device_and_dtype(tmp_path):
    """The reference's re-shard on load: here each leaf goes to the device
    asked for, in the dtype of the tree it is restored into."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(16.0).reshape(4, 4)}, blocking=True)
    out = mgr.restore({"w": torch.zeros(4, 4, dtype=torch.float64)},
                      device="cpu")
    assert out["w"].dtype == torch.float64
    assert torch.equal(out["w"], torch.arange(16.0).reshape(4, 4).double())
    with pytest.raises(ValueError, match="incompatible tree"):
        mgr.restore({"w": torch.zeros(4, 4), "b": torch.zeros(1)})


def test_train_resume_identical(tmp_path):
    """Crash/restart: resumed training state equals the saved one."""
    cfg = get_config("olmo-1b").scaled_down()
    hyper = TrainHyper(warmup=1)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    state = init_train_state(cfg, hyper, gen(), device="cpu")
    step = make_train_step(cfg, hyper)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    for i in range(3):
        state, _ = step(state, synthetic_batch(dc, i, device="cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, blocking=True)
    like = init_train_state(cfg, hyper, torch.Generator().manual_seed(1),
                            device="cpu")
    restored = mgr.restore(like)
    assert int(restored.step) == 3 and restored.model is like.model
    for name, p in state.model.named_parameters():
        assert torch.equal(dict(restored.model.named_parameters())[name], p)
        assert torch.equal(restored.opt.v[name], state.opt.v[name])
    state, m1 = step(state, synthetic_batch(dc, 3, device="cpu"))
    restored, m2 = step(restored, synthetic_batch(dc, 3, device="cpu"))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-6


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["none", "int8"])
def test_launcher_resume_continues_the_same_run(tmp_path, compression):
    """Training to step 4 straight equals training to 2, then resuming from
    the checkpoint to 4, at the loss of the last step."""
    kw = dict(seq_len=16, batch=2, log_every=1000, device="cpu",
              compression=compression)
    straight = launch_train.train("olmo-1b", steps=4, **kw)
    first = launch_train.train("olmo-1b", steps=2, ckpt_dir=str(tmp_path),
                               ckpt_every=1, **kw)
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    resumed = launch_train.train("olmo-1b", steps=4, ckpt_dir=str(tmp_path),
                                 resume=True, **kw)
    assert first["steps"] == resumed["steps"] == 2
    assert first["losses"] == straight["losses"][:2]
    assert abs(resumed["losses"][-1] - straight["losses"][-1]) < 1e-6
    assert len(straight["step_s"]) == 4 and straight["device"] == "cpu"


def test_quickstart_learns():
    """End-to-end: a tiny model's loss drops on the synthetic stream."""
    out = launch_train.train("olmo-1b", steps=60, seq_len=48, batch=8,
                             log_every=1000, device="cpu")
    assert out["last_loss"] < out["first_loss"] - 0.1, out


def test_train_cli_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", "recurrentgemma-2b", "--steps", "2",
                       "--seq-len", "12", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "over 2 steps on cpu" in out


def test_train_needs_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.train("olmo-1b", steps=1)
    with pytest.raises(ValueError, match="preset"):
        launch_train.train("olmo-1b", steps=1, preset="medium", device="cpu")
