"""The port's shared-cluster driver (``repro_torch.cluster``) and its card
constants (``repro_torch.roofline.hw``) against the JAX reference, on the
CPU.

`profile_from_arch` takes the reference's own TPU constants (its ``V5E``
fields, built into the port's `HwSpec` here) so the two compute the same
profile: bytes and compute gaps equal within 1e-12 relative (the same
float arithmetic in Python; measured equal), for all ten architectures,
with and without compression: the MoE configs' "dp+ep" profile has two
bursts an iteration (the expert all-to-all, then the data-parallel
all-reduce).

`simulate_shared_cluster` runs the example's three jobs at 0.1 s of
simulated time through both packages (the reference's ``run_plan`` on
JAX, the port's on its CPU path), on the reference's constants: the jobs'
iteration counts must be equal, and each per-job average iteration time
and the speedups within 2% (Tier B: loss and CNP draws threshold on
``expm1``, which the two libraries round differently, so runs may
diverge; measured equal).  The same holds for a mix with a MoE job
(deepseek-moe-16b beside two qwen3-1.7b jobs, the dp+ep profile), whose
points the chunk kernel takes on the card (no fallback reason).
"""
import dataclasses

import numpy as np
import pytest

from _torch_reference import load_reference, reference_modules

from repro_torch import cluster, netsim
from repro_torch.cluster import runner as prunner
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.optim import CompressionConfig
from repro_torch.roofline import H100, HwSpec

CLUSTER_JOBS = ["qwen3-1.7b", "qwen3-1.7b", "olmo-1b"]
MOE_JOBS = ["deepseek-moe-16b", "qwen3-1.7b", "qwen3-1.7b"]


def _v5e() -> HwSpec:
    """The reference's TPU constants, as the port's HwSpec."""
    ref = load_reference()["repro.roofline.hw"].V5E
    return HwSpec(**dataclasses.asdict(ref))


def _rcluster():
    return load_reference()["repro.cluster"]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("compression", [None, ("topk", 0.01),
                                         ("int8", 0.01)], ids=str)
def test_profile_from_arch_matches_reference(arch, compression):
    ref = load_reference()
    rcomp = pcomp = None
    if compression:
        rcomp = ref["repro.optim"].CompressionConfig(*compression)
        pcomp = CompressionConfig(*compression)
    want = _rcluster().profile_from_arch(
        ref["repro.configs"].get_config(arch), compression=rcomp)
    got = cluster.profile_from_arch(get_config(arch), compression=pcomp,
                                    hw=_v5e())
    assert (got.name, got.parallelism) == (want.name, want.parallelism)
    np.testing.assert_allclose(got.comm_bytes, want.comm_bytes, rtol=1e-12)
    np.testing.assert_allclose(got.compute_s, want.compute_s, rtol=1e-12)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_profiles_have_two_bursts(arch):
    prof = cluster.profile_from_arch(get_config(arch))
    assert prof.parallelism == "dp+ep"
    assert len(prof.comm_bytes) == len(prof.compute_s) == 2
    # the all-to-all is the smaller burst; the gap splits 60/40 around it
    assert 0 < prof.comm_bytes[0] < prof.comm_bytes[1]
    np.testing.assert_allclose(prof.compute_s[0] / prof.compute_s[1], 1.5)
    one_pod = cluster.profile_from_arch(get_config(arch), pods=1)
    assert one_pod.parallelism == "dp" and len(one_pod.comm_bytes) == 1


def test_h100_constants_and_default():
    assert (H100.peak_flops_bf16, H100.hbm_bw, H100.ici_link_bw,
            H100.hbm_bytes) == (989e12, 3.35e12, 50e9, 80e9)
    cfg = get_config("olmo-1b")
    on_card = cluster.profile_from_arch(cfg)
    on_tpu = cluster.profile_from_arch(cfg, hw=_v5e())
    assert on_card.comm_bytes == on_tpu.comm_bytes
    np.testing.assert_allclose(on_card.compute_s[0] * 989e12,
                               on_tpu.compute_s[0] * _v5e().peak_flops_bf16,
                               rtol=1e-12)


def _captured(module, monkeypatch):
    """Wrap ``module.netsim.run_plan`` so the test sees its PlanResult."""
    seen = []
    run_plan = module.netsim.run_plan

    def wrapped(*args, **kw):
        seen.append(run_plan(*args, **kw))
        return seen[-1]
    monkeypatch.setattr(module.netsim, "run_plan", wrapped)
    return seen


def _cluster_against_reference(jobs, monkeypatch, **kw):
    """Both packages' `simulate_shared_cluster` on ``jobs`` at 0.1 s (and
    ``kw``), the port on the CPU: the reports, held to the module's Tier B
    bounds, and the port's PlanResult."""
    rrunner = load_reference()["repro.cluster"].runner
    with reference_modules():
        rseen = _captured(rrunner, monkeypatch)
        want = rrunner.simulate_shared_cluster(jobs, sim_time=0.1, **kw)
    pseen = _captured(prunner, monkeypatch)
    got = cluster.simulate_shared_cluster(jobs, sim_time=0.1, hw=_v5e(),
                                          device="cpu", **kw)
    assert isinstance(got, cluster.ClusterReport)
    assert got.jobs == want.jobs == jobs
    for scheme in ("default", "mltcp"):
        (r,), (p,) = (rseen[0].select(scheme=scheme),
                      pseen[0].select(scheme=scheme))
        assert [len(x) for x in p.iter_times] == \
            [len(x) for x in r.iter_times], scheme
        assert min(len(x) for x in p.iter_times) > 5     # past the warmup
    for name in ("baseline_avg", "mltcp_avg"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0.02)
    for name in ("avg_speedup", "p99_speedup", "interleave_before",
                 "interleave_after"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0.02, atol=0.02)
    return pseen[0]


def test_simulate_shared_cluster_matches_reference(monkeypatch):
    _cluster_against_reference(CLUSTER_JOBS, monkeypatch)


def test_moe_cluster_mix_matches_reference_and_takes_the_chunk_kernel(
        monkeypatch):
    # a fifth of the example's work scale: the MoE job's iteration (~25 ms
    # at 0.05 on the reference's constants) would leave it one in 0.1 s
    pr = _cluster_against_reference(MOE_JOBS, monkeypatch, work_scale=0.01)
    for scheme in ("default", "mltcp"):
        cfg = pr.plan.build({"scheme": scheme})
        # the MoE job's two comm phases an iteration
        assert list(cfg.jobs.n_phases) == [2, 1, 1]
        sweep = netsim.make_sweep(cfg, device="cpu")
        assert ops.chunk_fallback_reason(cfg, sweep) is None
