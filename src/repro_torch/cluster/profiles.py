"""Per-iteration communication profiles of the assigned architectures (the
port of ``repro/cluster/profiles.py``, with the same arithmetic).

The deployment model: a job trains on ``pods`` pods of ``chips_per_pod``
accelerators; within a pod the tensor- and expert-parallel traffic rides
the pod's own fabric, but the data-parallel gradient all-reduce across
pods rides the shared data-center network, which is the traffic MLTCP
schedules, and several jobs' pods share its links.

  comm_bytes/iter = 2 * (pods-1)/pods * grad_bytes        (ring all-reduce)
  compute_s/iter  = MODEL_FLOPS / (chips * peak * MFU)

MoE archs add a second, smaller burst before it (parallelism "dp+ep"): the
expert-parallel all-to-all spilling across pods when the experts outgrow
one pod, with the compute gap split 60/40 around it.  ``hw`` is the
accelerator (`roofline.hw.H100` by default; the reference's default is its
TPU).  Parameter counts come from the port's `transformer.param_count` on
the ``meta`` device.
"""
from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.grad_compress import CompressionConfig, wire_bytes
from repro_torch.roofline.hw import H100, HwSpec
from repro_torch.workload.comm_model import CommProfile


def profile_from_arch(cfg: ModelConfig, *, pods: int = 2,
                      chips_per_pod: int = 64,
                      tokens_per_iter: int = 16 * 4096,
                      mfu: float = 0.4,
                      grad_dtype_bytes: float = 2.0,
                      dcn_nics: int = 16,
                      compression: CompressionConfig | None = None,
                      hw: HwSpec = H100) -> CommProfile:
    """Defaults model the *contended* regime the paper studies: modest
    fine-tuning slices (64 accelerators a pod, 64k-token batches) whose
    cross-pod gradient all-reduce rides ``dcn_nics`` shared 50 Gbps
    uplinks."""
    n_params = transformer.param_count(cfg)
    n_active = transformer.active_param_count(cfg)

    grad_bytes = n_params * grad_dtype_bytes
    if compression is not None and compression.scheme != "none":
        grad_bytes = wire_bytes(compression, n_params, pods) \
            / (2.0 * (pods - 1) / pods)
    # bytes per shared uplink of the cross-pod all-reduce
    dcn_bytes = 2.0 * (pods - 1) / pods * grad_bytes / dcn_nics

    flops = 6.0 * n_active * tokens_per_iter
    compute_s = flops / (pods * chips_per_pod * hw.peak_flops_bf16 * mfu)

    if cfg.moe is not None and pods > 1:
        # expert-parallel all-to-all spillover across pods: each token's
        # hidden vector crosses the shared network once in each direction
        # for the fraction of experts living on the other pod
        frac_remote = (pods - 1) / pods
        a2a = (2.0 * tokens_per_iter * cfg.moe.top_k * cfg.d_model
               * grad_dtype_bytes * frac_remote) / (pods * dcn_nics)
        return CommProfile(name=cfg.name,
                           compute_s=(compute_s * 0.6, compute_s * 0.4),
                           comm_bytes=(a2a, dcn_bytes), parallelism="dp+ep")
    return CommProfile(name=cfg.name, compute_s=(compute_s,),
                       comm_bytes=(dcn_bytes,), parallelism="dp")
