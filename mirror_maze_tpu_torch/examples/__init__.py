"""Runnable showcases of the port (counterparts of the repository's
``examples/``): ``python -m mirror_maze_tpu_torch.examples.cornell_box``,
``.mesh_gallery`` and ``.multiplayer_demo``. Each runs on the CUDA card
unless given ``--device cpu``."""
