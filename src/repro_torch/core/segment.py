"""Order-fixed reductions over the static flow→job grouping and over
small tensor axes.

The reference sums per-job values with ``zeros.at[f2j].add(x)``.  On CUDA,
``index_add_`` / ``index_put_(accumulate=True)`` add with atomics in no
fixed order, so a job with three or more flows could sum to different
floats from run to run.  Here each job's members are listed once, at
build time, in flow order (`JobGroups.members`), and a sum is a fold of
one gather per member slot: ``((x[m0] + x[m1]) + x[m2]) + ...``.  The
order is fixed by the table, not by the device's scheduling, so the same
inputs give the same sum on every run, on the CPU and on the card, and it
is the left-to-right order of the reference's CPU scatter.

`fold_sum` does the same along a tensor axis.  ``torch.sum`` picks its
association by shape (measured: a [K, M, N] sum over N changes in the
last bit when K changes or zero columns are appended), which would break
the port's bitwise invariants (a K-point sweep row equals a single run;
a padded fabric equals an unpadded one).  A left fold has one order for
every shape, and appending zeros leaves it exact.  It costs one add per
element of the axis, so it is only for the engine's short axes (flows of
one link, links of one path).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class JobGroups:
    """The static socket→job map, with each job's flows listed in order.

    ``f2j`` [N] long; ``members`` [J, S] long, flow indices per job padded
    with N (a gather past the last flow, which the folds fill with their
    neutral value); ``padded`` says whether any job has fewer than S flows;
    ``blocked`` whether job j owns flows j*S .. j*S+S-1 exactly (every
    layout `netsim.topology` makes), so a [..., N] tensor views as [..., J, S].
    """

    f2j: Tensor
    members: Tensor
    n_jobs: int
    padded: bool
    blocked: bool

    @staticmethod
    def build(flow_to_job, n_jobs: int, device) -> "JobGroups":
        f2j = np.asarray(
            flow_to_job.cpu() if isinstance(flow_to_job, Tensor)
            else flow_to_job, np.int64).reshape(-1)
        n = f2j.shape[0]
        rows = [np.flatnonzero(f2j == j) for j in range(n_jobs)]
        s = max([len(r) for r in rows] + [1])
        members = np.full((n_jobs, s), n, np.int64)
        for j, r in enumerate(rows):
            members[j, :len(r)] = r
        return JobGroups(
            f2j=torch.as_tensor(f2j, device=device),
            members=torch.as_tensor(members, device=device),
            n_jobs=n_jobs,
            padded=bool(any(len(r) < s for r in rows)),
            blocked=bool(np.array_equal(members.reshape(-1),
                                        np.arange(n_jobs * s))))

    def _gather(self, x: Tensor, fill) -> Tensor:
        """[..., N] -> [..., J, S] member values (``fill`` past the end)."""
        shape = x.shape[:-1] + tuple(self.members.shape)
        if self.blocked:
            return x.reshape(shape)
        if self.padded:
            pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype,
                             device=x.device)
            x = torch.cat([x, pad], dim=-1)
        return x.index_select(-1, self.members.view(-1)).view(shape)

    def sum(self, x: Tensor, init: Tensor | None = None) -> Tensor:
        """Per-job sums of a [..., N] tensor, folded in flow order onto
        ``init`` ([..., J]) when given — ``init.at[f2j].add(x)``."""
        g = self._gather(x, 0.0)
        acc = g[..., 0] if init is None else init + g[..., 0]
        for s in range(1, g.shape[-1]):
            acc = acc + g[..., s]
        return acc

    def min(self, x: Tensor, init) -> Tensor:
        """Per-job minima of a [..., N] tensor and ``init`` — min is exact,
        so any order gives the same value."""
        return torch.clamp_max(torch.amin(self._gather(x, init), dim=-1),
                               init)

    def spread(self, x: Tensor) -> Tensor:
        """A per-job [..., J] tensor read out per flow: ``x[..., f2j]``."""
        return x.index_select(-1, self.f2j)


def fold_sum(x: Tensor, dim: int) -> Tensor:
    """Sum along ``dim`` as the left fold ``((x0 + x1) + x2) + ...``."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc
