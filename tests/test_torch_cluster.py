"""The port's shared-cluster driver (``repro_torch.cluster``) and its card
constants (``repro_torch.roofline.hw``) against the JAX reference, on the
CPU.

`profile_from_arch` takes the reference's own TPU constants (its ``V5E``
fields, built into the port's `HwSpec` here) so the two compute the same
profile: bytes and compute gaps equal within 1e-12 relative (the same
float arithmetic in Python; measured equal), for every architecture the
port's model stack builds, with and without compression.  The others
raise, naming their ROADMAP item.

`simulate_shared_cluster` runs the example's three jobs at 0.1 s of
simulated time through both packages (the reference's ``run_plan`` on
JAX, the port's on its CPU path), on the reference's constants: the jobs'
iteration counts must be equal, and each per-job average iteration time
and the speedups within 2% (Tier B: loss and CNP draws threshold on
``expm1``, which the two libraries round differently, so runs may
diverge; measured equal).
"""
import dataclasses

import numpy as np
import pytest

from _torch_reference import load_reference, reference_modules

from repro_torch import cluster
from repro_torch.cluster import runner as prunner
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.optim import CompressionConfig
from repro_torch.roofline import H100, HwSpec

UNPORTED = {"deepseek-moe-16b": "item 14", "llama4-maverick-400b-a17b":
            "item 14", "xlstm-125m": "item 15",
            "seamless-m4t-medium": "item 16"}
CLUSTER_JOBS = ["qwen3-1.7b", "qwen3-1.7b", "olmo-1b"]


def _v5e() -> HwSpec:
    """The reference's TPU constants, as the port's HwSpec."""
    ref = load_reference()["repro.roofline.hw"].V5E
    return HwSpec(**dataclasses.asdict(ref))


def _rcluster():
    return load_reference()["repro.cluster"]


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in UNPORTED])
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


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_profile_from_arch_raises_for_unported_models(arch):
    with pytest.raises(NotImplementedError, match=UNPORTED[arch]):
        cluster.profile_from_arch(get_config(arch))


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


def test_simulate_shared_cluster_matches_reference(monkeypatch):
    rrunner = load_reference()["repro.cluster"].runner
    with reference_modules():
        rseen = _captured(rrunner, monkeypatch)
        want = rrunner.simulate_shared_cluster(CLUSTER_JOBS, sim_time=0.1)
    pseen = _captured(prunner, monkeypatch)
    got = cluster.simulate_shared_cluster(CLUSTER_JOBS, sim_time=0.1,
                                          hw=_v5e(), device="cpu")
    assert isinstance(got, cluster.ClusterReport)
    assert got.jobs == want.jobs == CLUSTER_JOBS
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
