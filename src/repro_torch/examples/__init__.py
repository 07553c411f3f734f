"""repro_torch.examples: the four example scripts on the port.

The counterparts of the JAX package's ``examples/`` scripts, the entry
points a new user runs first: one module each, with the script's name,
its printed lines in its order, and ``main(argv=None)``.  Each runs with

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

on the CUDA card unless ``--device cpu``.  Their other options exist only
to cut a run's size, and default to the reference script's values.

* `quickstart`: trains xlstm-125m (the ``smoke`` preset) and asserts the
  loss drops;
* `serve_lm`: the serving launcher (`launch.serve`);
* `simulate_cluster`: the framework's own training jobs on one link,
  default DCQCN against MLTCP (`cluster.simulate_shared_cluster`);
* `interleave_demo`: MLTCP's interleaving as ASCII probe timelines, with
  telemetry armed (`netsim.run_plan`).
"""
