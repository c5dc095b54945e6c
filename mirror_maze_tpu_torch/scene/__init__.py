from .builder import Scene, SceneDerived, build_scene  # noqa: F401
from .bvh import BVH, build_bvh  # noqa: F401
from .collision import collides  # noqa: F401
from .io import load_scene, save_scene  # noqa: F401
from .maze import generate_maze, merge_horizontal_walls, merge_vertical_walls  # noqa: F401
from .mesh import (  # noqa: F401
    icosphere,
    load_obj,
    merge_scenes,
    mesh_scene,
    save_obj,
    transform_vertices,
)
