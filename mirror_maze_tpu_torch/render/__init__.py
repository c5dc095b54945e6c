from .accumulate import (  # noqa: F401
    cm_to_spatial,
    feedback_blur_cm,
    quantize_8bit,
    scatter_chunk_rows,
    to_display,
)
from .camera import Camera, make_camera, ray_directions  # noqa: F401
from .fused_tracer import trace_paths_fused, trace_paths_plain  # noqa: F401
from .pipeline import render_pixels  # noqa: F401
from .present import present, present_plain  # noqa: F401
from .scenebuf import DeviceScene, upload_scene  # noqa: F401
from .scheduler import (  # noqa: F401
    chunk_origin_xy,
    chunk_pixels,
    init_permutation,
    sort_window_morton,
    take_chunks,
)
from .tracer import tone_map  # noqa: F401
