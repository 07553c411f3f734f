"""Training step factory: loss, gradients, AdamW, optional microbatching and
gradient compression.

The port of ``repro/train/train_step.py``.  A `TrainState` holds the model
(an ``nn.Module``; its parameters by name are the reference's parameter
tree), the AdamW state, the error-feedback residual and the step.  The step
updates the model's parameters and the moments in place (the reference
donates its state to ``jit``) and returns a new `TrainState` around them.
Gradients come from ``torch.autograd.grad`` over the parameters, so no
``.grad`` is kept between steps.

The reference's ``unroll`` knob has no counterpart (there is no
``lax.scan`` of layer groups to unroll), nor its sharding rules
(``repro/train/sharding.py``), which place a step on a TPU mesh: the port
trains on one card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, AdamWState, CompressionConfig,
                               adamw_init, adamw_update, compress_gradients,
                               cosine_schedule, init_error_feedback)

Tensor = torch.Tensor

_PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    opt: AdamWConfig = AdamWConfig()
    warmup: int = 100
    total_steps: int = 10_000
    aux_weight: float = 0.01           # MoE load-balance loss weight
    microbatches: int = 1              # gradient accumulation
    compression: CompressionConfig = CompressionConfig()
    # None: the kernels where the activations are on a CUDA device, the
    # plain path on the CPU (`repro_torch.device.use_kernels`)
    use_kernel: Optional[bool] = None
    remat: bool = True
    param_dtype: str = "float32"       # "bfloat16" = mixed-precision training


class TrainState(NamedTuple):
    model: torch.nn.Module
    opt: AdamWState
    residual: Optional[dict]           # error feedback (None: no compression)
    step: Tensor                       # int32, 0-d


def init_train_state(cfg: ModelConfig, hyper: TrainHyper,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """A fresh model (from ``generator``; None seeds one with 0) in
    ``hyper.param_dtype``, zero moments and residuals, step 0, on
    ``device`` (None: the CUDA card)."""
    dev = resolve(device)
    model = api.init_params(cfg, generator, dev)
    model.to(_PARAM_DTYPES[hyper.param_dtype])
    params = dict(model.named_parameters())
    resid = (init_error_feedback(params)
             if hyper.compression.scheme != "none" else None)
    return TrainState(model=model, opt=adamw_init(hyper.opt, params),
                      residual=resid,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def loss_fn(cfg: ModelConfig, model, batch: dict, hyper: TrainHyper
            ) -> tuple[Tensor, dict]:
    """Mean next-token NLL from a float32 log-softmax, plus ``aux_weight``
    times the auxiliary loss; vision-prefix positions are not scored."""
    logits, aux = api.forward(cfg, model, batch, use_kernel=hyper.use_kernel,
                              remat=hyper.remat)
    tokens = batch["tokens"]
    prefix = logits.shape[1] - tokens.shape[1]
    logits = logits[:, prefix:]
    targets = tokens[:, 1:]
    pred = logits[:, :-1]
    logp = torch.log_softmax(pred.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    ce = nll.mean()
    loss = ce + hyper.aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


def make_train_step(cfg: ModelConfig, hyper: TrainHyper):
    """Returns train_step(state, batch) -> (state, metrics).  With
    ``microbatches`` > 1 every batch leaf arrives pre-split, [mb, gb/mb,
    ...], and the gradients are summed over a loop along that axis."""

    def grads_of(params: dict, model, batch: dict):
        loss, metrics = loss_fn(cfg, model, batch, hyper)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def train_step(state: TrainState, batch: dict):
        params = dict(state.model.named_parameters())
        if hyper.microbatches > 1:
            mb = hyper.microbatches
            if not all(x.shape[0] == mb for x in batch.values()):
                raise ValueError(f"microbatched train_step expects leading "
                                 f"dim {mb}")
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in params.items()}
            loss = 0.0
            for i in range(mb):
                part_loss, metrics, part = grads_of(
                    params, state.model, {k: v[i] for k, v in batch.items()})
                for name, g in part.items():
                    grads[name].add_(g)
                loss = loss + part_loss
                del part
            for g in grads.values():
                g.div_(mb)
            loss = loss / mb
        else:
            loss, metrics, grads = grads_of(params, state.model, batch)

        residual = state.residual
        if hyper.compression.scheme != "none":
            grads, residual = compress_gradients(hyper.compression, grads,
                                                 residual)

        lr_scale = cosine_schedule(state.step, hyper.warmup,
                                   hyper.total_steps)
        _, opt, opt_metrics = adamw_update(hyper.opt, state.opt, params,
                                           grads, lr_scale)
        del grads
        new_state = TrainState(model=state.model, opt=opt, residual=residual,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **opt_metrics,
                           "lr_scale": lr_scale}

    return train_step
