"""launch — entry points: `serve`, `train`, and `dryrun` (every
architecture x input-shape cell counted on the ``meta`` device).

The reference's ``launch/mesh.py`` builds its 256- and 512-chip TPU
meshes (16 x 16 and 2 x 16 x 16); the port runs on one card and has no
mesh, so nothing stands for it.
"""
