"""Tools of the port (counterparts of the repository's ``tools/``):
``python -m mirror_maze_tpu_torch.tools.soak_kernel``."""
