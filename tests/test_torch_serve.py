"""The port's serving path on the CPU: the launcher end to end for every
arch, the invariants inside the port, and parameter counts against the
reference.

Tolerances inside the port, measured on the CPU (torch 2.13): teacher-
forced decode against `forward` within 1.8e-6 (logits up to ~3.4;
recurrentgemma: the sequential decode step against the log-depth scan
of `forward`; the others: grouped decode attention against dense
`attend`), and the prefill's kernel path (on the CPU the kernels' plain
versions: dense `ref_attention`, the sequential `ref_rg_lru`) against its
plain path within 7.6e-7 on logits and 3.1e-6 on caches (recurrentgemma;
bitwise for the attention-only archs).  The bounds are atol = rtol =
1e-5.  Teacher-forced decode of the MoE archs runs at a capacity factor
that drops no token (a step routes B tokens, the forward B x T), and of
the encoder-decoder from a cache whose cross-attention K/V
`encdec.prefill_cross` computed from the encoded frames.
"""
from types import SimpleNamespace

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as rtransformer

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import needs_grad, use_kernels
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rg_lru as trl
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import api, encdec, transformer
from repro_torch.train import generate

TOL = dict(atol=1e-5, rtol=1e-5)
PORTED = ["recurrentgemma-2b", "gemma2-27b", "qwen3-1.7b", "olmo-1b",
          "qwen1.5-4b", "internvl2-1b", "deepseek-moe-16b",
          "llama4-maverick-400b-a17b", "xlstm-125m", "seamless-m4t-medium"]


def _model(arch, **over):
    cfg = get_config(arch).scaled_down(**over)
    gen = torch.Generator().manual_seed(3)
    return cfg, api.init_params(cfg, gen, device="cpu")


def test_every_arch_is_ported_or_names_its_item():
    assert sorted(PORTED) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", PORTED)
def test_serve_smoke_runs_end_to_end(arch):
    out = serve(arch, batch=2, prompt_len=12, new_tokens=5, preset="smoke",
                seed=1, device="cpu")
    cfg = out["cfg"]
    ids = out["generated"]
    assert ids.shape == (2, 5) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_padded
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0
    # the launcher's loop is `generate` with the kernels on
    again = generate(cfg, out["model"], out["request"], 5, out["max_len"],
                     use_kernel=True)
    assert torch.equal(again, ids)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_main(["--arch", "qwen3-1.7b", "--batch", "1", "--prompt-len", "6",
                "--new", "3", "--device", "cpu"])
    assert "decode" in capsys.readouterr().out


def test_serve_counts_no_launch_on_the_cpu():
    before = (tfa.LAUNCH_COUNT, trl.LAUNCH_COUNT)
    serve("recurrentgemma-2b", batch=1, prompt_len=8, new_tokens=2,
          device="cpu")
    assert (tfa.LAUNCH_COUNT, trl.LAUNCH_COUNT) == before


def test_serve_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("qwen3-1.7b", batch=1, prompt_len=4, new_tokens=2)


def _frames(cfg, b, t, gen):
    return torch.randn((b, max(t // cfg.enc_seq_divisor, 4), cfg.d_model),
                       generator=gen)


@pytest.mark.parametrize("arch", [a for a in PORTED if a != "internvl2-1b"])
def test_teacher_forced_decode_equals_forward(arch):
    base = get_config(arch)
    over = dict(capacity_factor=4.0) if base.moe else {}
    cfg, model = _model(arch, window=4, **over)
    b, t = 2, 10
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen)
    batch = {"tokens": toks}
    with torch.no_grad():
        if api.is_encdec(cfg):
            batch["frames"] = _frames(cfg, b, t, gen)
            memory = encdec.encode(cfg, model, batch["frames"])
            cache = encdec.prefill_cross(
                cfg, model, memory, api.init_cache(
                    cfg, b, t, device="cpu", enc_len=memory.shape[1]))
        else:
            cache = api.init_cache(cfg, b, t, device="cpu")
        full, _ = api.forward(cfg, model, batch)
        steps = []
        for i in range(t):
            logits, cache = api.decode_step(cfg, model, cache, toks[:, i], i)
            steps.append(logits)
    torch.testing.assert_close(torch.stack(steps, dim=1), full, **TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_kernel_path_equals_plain_path(arch):
    cfg, model = _model(arch, window=5)
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 11), generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.vision_tokens, cfg.vit_dim),
                                       generator=gen)
    if cfg.family == "audio":
        batch["frames"] = _frames(cfg, 2, 11, gen)
    with torch.no_grad():
        lk, ck = api.prefill(cfg, model, batch, 24, use_kernel=True)
        lp, cp = api.prefill(cfg, model, batch, 24, use_kernel=False)
    torch.testing.assert_close(lk, lp, **TOL)
    assert ck.keys() == cp.keys()
    for i in cp:
        assert ck[i].keys() == cp[i].keys()
        for name in cp[i]:
            torch.testing.assert_close(ck[i][name], cp[i][name], **TOL)


def _operand(device, requires_grad=False):
    """What `use_kernels` reads of a tensor, for devices the CPU lacks."""
    return SimpleNamespace(device=torch.device(device),
                           requires_grad=requires_grad)


# (use_kernel, operands' devices, operands require grad, grad mode, want)
@pytest.mark.parametrize("use_kernel,devices,grad,grad_mode,want", [
    (None, ("cuda",), False, True, True),
    (None, ("cuda:0", "cuda:0"), False, True, True),
    (None, ("cpu",), False, True, False),
    (None, ("cuda", "cpu"), False, True, False),
    # the kernels have a backward pass: also where autograd records ...
    (None, ("cuda", "cuda"), True, True, True),
    # ... and under no_grad
    (None, ("cuda", "cuda"), True, False, True),
    (True, ("cpu",), False, True, True),
    (True, ("cuda",), True, True, True),
    (False, ("cuda",), False, False, False),
    (False, ("cpu",), False, True, False)])
def test_use_kernel_none_means_the_kernels_on_a_cuda_device(
        use_kernel, devices, grad, grad_mode, want):
    operands = [_operand(d, requires_grad=grad and i == 0)
                for i, d in enumerate(devices)]
    with torch.set_grad_enabled(grad_mode):
        assert use_kernels(use_kernel, *operands) is want


def test_needs_grad_reads_grad_mode_and_requires_grad():
    w = torch.ones(2, requires_grad=True)
    x = torch.ones(2)
    assert needs_grad(x, w) and needs_grad(w * 2, None)
    assert not needs_grad(x, None) and not needs_grad()
    with torch.no_grad():
        assert not needs_grad(w) and not needs_grad(w * 2)


def _count_kernel_calls(monkeypatch):
    from repro_torch.kernels import ops

    calls = {"flash_attention": 0, "rg_lru": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(ops, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(ops, name, counted)
    return calls


def test_prefill_default_is_the_plain_path_on_the_cpu(monkeypatch):
    calls = _count_kernel_calls(monkeypatch)
    cfg, model = _model("recurrentgemma-2b", window=5)
    gen = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 11), generator=gen)}
    with torch.no_grad():
        ld, cd = api.prefill(cfg, model, batch, 24)
        assert calls == {"flash_attention": 0, "rg_lru": 0}
        lp, _ = api.prefill(cfg, model, batch, 24, use_kernel=False)
        assert torch.equal(ld, lp)
        api.prefill(cfg, model, batch, 24, use_kernel=True)
    kinds = [blk.kind for blk in model.layers]
    assert calls == {"flash_attention": kinds.count("attn_local"),
                     "rg_lru": kinds.count("rec")}


@pytest.mark.cuda
def test_prefill_default_launches_the_kernels_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels launch only there "
                    "(chip_smoke.py counts the serve prefill's launches)")
    cfg = get_config("recurrentgemma-2b").scaled_down(window=5)
    dev = torch.device("cuda")
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                            device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 11), device=dev)}
    before = (tfa.LAUNCH_COUNT, trl.LAUNCH_COUNT)
    with torch.no_grad():
        api.prefill(cfg, model, batch, 24)
    kinds = [blk.kind for blk in model.layers]
    assert (tfa.LAUNCH_COUNT - before[0], trl.LAUNCH_COUNT - before[1]) == \
        (kinds.count("attn_local"), kinds.count("rec"))


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_equal_the_reference_at_full_size(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert transformer.param_count(cfg) == rtransformer.param_count(ref_cfg)
    assert (transformer.active_param_count(cfg)
            == rtransformer.active_param_count(ref_cfg))


def test_full_recurrentgemma_on_meta_allocates_nothing():
    cfg = get_config("recurrentgemma-2b")
    model = api.init_params(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    kinds = [blk.kind for blk in model.layers]
    # the serve path's prefill: 8 flash launches and 18 RG-LRU launches
    assert kinds.count("attn_local") == 8 and kinds.count("rec") == 18
    assert 2.6e9 < transformer.param_count(cfg) < 3.0e9
