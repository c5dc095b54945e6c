from .accumulate import (  # noqa: F401
    cm_to_spatial,
    feedback_blur,
    feedback_blur_cm,
    quantize_8bit,
    scatter_chunk_rows,
    scatter_chunks,
    spatial_to_cm,
    to_display,
)
from .camera import Camera, make_camera, ray_directions  # noqa: F401
from .campath import (orbit_cameras, render_path, spin_cameras,  # noqa: F401
                      waypoint_cameras)
from .fused_tracer import tile_order, trace_paths_fused, trace_paths_plain  # noqa: F401
from .intersect import (  # noqa: F401
    nearest_hit_brute,
    nearest_hit_bvh,
    nearest_hit_bvh_kernel,
    nearest_hit_exact,
    ray_aabb,
)
from .pipeline import make_nearest_fn, render_full_frame, render_pixels  # noqa: F401
from .present import present, present_plain  # noqa: F401
from .scenebuf import DeviceScene, tile_table, upload_scene  # noqa: F401
from .scheduler import (  # noqa: F401
    chunk_origin_xy,
    chunk_pixels,
    init_permutation,
    sort_window_morton,
    take_chunks,
)
from .tracer import tone_map, trace_paths  # noqa: F401
