"""launch — entry points: `serve`, `train`, and `dryrun` (every
architecture x input-shape cell counted on the ``meta`` device, on one card
or per device of the 16 x 16 and 2 x 16 x 16 meshes), and `mesh` (the
port of ``repro/launch/mesh.py``: the production meshes as
``DeviceMesh``es over a fake process group for counting, or NCCL / gloo
for running).
"""
