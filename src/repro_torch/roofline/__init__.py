"""roofline — the card's data-sheet constants (`hw.H100`), the roofline
terms of every dry-run cell on one card or per device of a mesh
(`analysis`, over `repro_torch.launch.dryrun`'s counts), and
`collectives`, the counterpart of ``repro/roofline/hlo.py``: where the
reference parses the collectives out of the partitioned HLO, a
``TorchDispatchMode`` counts those a DTensor step issues, under the
reference's kinds and keys.  The static verifier's budgets
(`repro_torch.analysis.budget`) stand for hlo.py's ``cost_envelope``.

`hillclimb`, the port of ``repro/roofline/hillclimb.py``, runs the
reference's twelve experiments: each a cell counted on the 16x16 mesh
by `analysis.roofline_cell` under a sharding rule and the four knobs
(`models.attention`'s ``SEQ_SHARD_AXIS`` and ``DECODE_GROUPED_GQA``,
`models.moe`'s ``DISPATCH_MODE`` and ``EP_CONSTRAINT_AXIS``), on the
plain route and on the kernels'.
"""

from repro_torch.roofline.hw import H100, HwSpec

__all__ = ["H100", "HwSpec"]
