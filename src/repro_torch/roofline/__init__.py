"""roofline — the card's data-sheet constants (`hw.H100`), the roofline
terms of every dry-run cell on one card or per device of a mesh
(`analysis`, over `repro_torch.launch.dryrun`'s counts), and
`collectives`, the counterpart of ``repro/roofline/hlo.py``: where the
reference parses the collectives out of the partitioned HLO, a
``TorchDispatchMode`` counts those a DTensor step issues, under the
reference's kinds and keys.  The static verifier's budgets
(`repro_torch.analysis.budget`) stand for hlo.py's ``cost_envelope``.

``repro/roofline/hillclimb.py`` waits for a later slice: it searches four
knobs (``SEQ_SHARD_AXIS``, ``DECODE_GROUPED_GQA``, ``DISPATCH_MODE``,
``EP_CONSTRAINT_AXIS``) by counting cells on the mesh that
`launch.mesh` now builds; the port has the first and the last
(`models.attention`, `models.moe`), always decodes grouped and dropped
the dispatch mode.
"""

from repro_torch.roofline.hw import H100, HwSpec

__all__ = ["H100", "HwSpec"]
