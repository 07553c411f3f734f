"""repro_torch.figures: the paper-figure suites on the port.

The counterpart of the JAX package's ``benchmarks/`` (named so as not to
be taken for a benchmark of the port): one module per suite, each with its
reference module's name, public functions and signatures, plus a
``device=None`` keyword (the card unless ``"cpu"``) that reaches
`netsim.run_plan`.  Each suite returns ``(derived, n_ticks)`` with the
reference's keys; ``python -m repro_torch.figures`` runs them all
(`__main__`).  `repro_torch.analysis.plans` builds its named plans from
these suites' plan builders.
"""
