"""roofline — the card's data-sheet constants (`hw.H100`) and the roofline
terms of every dry-run cell on it (`analysis`, over
`repro_torch.launch.dryrun`'s counts).

Two reference modules have no one-card counterpart:

* ``repro/roofline/hlo.py`` parses the collectives out of a compiled XLA
  module's HLO text.  The port compiles no HLO and one card runs no
  collective; the dry run counts its FLOPs and bytes op by op, and the
  static verifier's budgets (`repro_torch.analysis.budget`) stand for its
  ``cost_envelope``.
* ``repro/roofline/hillclimb.py`` searches four knobs of the pod mesh
  (``SEQ_SHARD_AXIS``, ``DECODE_GROUPED_GQA``, ``DISPATCH_MODE``,
  ``EP_CONSTRAINT_AXIS``) by lowering cells on it.  They choose how a step
  is sharded; the port runs on one card, has no sequence-shard axis
  (`models.attention`), dropped the dispatch mode and pins no expert axis
  (`models.moe`), and always decodes grouped.
"""

from repro_torch.roofline.hw import H100, HwSpec

__all__ = ["H100", "HwSpec"]
