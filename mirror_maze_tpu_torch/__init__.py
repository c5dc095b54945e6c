"""mirror-maze engine on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``mirror_maze_tpu``, which stays the reference:
the same scene build, camera, scheduler and engine step, with the two
Pallas kernels rewritten by hand in CUDA C++ (``csrc/``). Imports torch and
numpy only. Entry points take ``device=None``, which means the CUDA card
(and raises without one); the CPU runs only when a caller asks for it.
"""

from .config import (  # noqa: F401
    CameraConfig,
    EngineConfig,
    MazeConfig,
    NAMED_CONFIGS,
    ScreenConfig,
    TracerConfig,
)

__version__ = "0.1.0"
