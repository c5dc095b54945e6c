"""Randomized-Kruskal maze generation and wall-run merging.

Reimplements the reference's host-side maze pipeline (`main.rs:328-438`):
a union-find over the cell grid, a seeded shuffle of all interior edges,
knock-down of walls between unconnected components, and compression of the
remaining walls into maximal contiguous runs. This is init-time host work on
O(width*height) cells — it stays NumPy (deterministic by seed) and only its
*output* (scene arrays) lives on device.

Cell-opening bitmask matches the reference (`main.rs:388-394`):
bit 1 = open up (toward y-1), 2 = open down, 4 = open left (x-1), 8 = open right.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class UnionFind:
    """Union-find matching the reference's TreeBuilder (`main.rs:328-352`):
    no path compression, no rank; connect() hangs the child's root under the
    given parent *node* (not the parent's root)."""

    def __init__(self, n: int):
        self.parent = [-1] * n  # -1 == None (root)

    def root(self, i: int) -> int:
        while self.parent[i] != -1:
            i = self.parent[i]
        return i

    def connected(self, a: int, b: int) -> bool:
        return self.root(a) == self.root(b)

    def connect(self, parent: int, child: int) -> None:
        self.parent[self.root(child)] = parent


def generate_maze(width: int, height: int, rng) -> np.ndarray:
    """Kruskal's algorithm on a width x height cell grid (`main.rs:356-396`).

    Edges (x, y, up) exist for every y>0 (up-edge) and x>0 (left-edge); they
    are shuffled with the supplied generator, then each edge joining two
    unconnected components is knocked down and recorded in the bitmask grid.
    `rng` is either a `np.random.Generator` (shuffle via `permutation` —
    the historical path, pinned by goldens) or a `utils.refrng.StdRng08`
    (in-place Fisher-Yates, bit-matching the reference's
    `edges.shuffle(&mut rng)` at `main.rs:382`).

    Returns the [height, width] uint8 open-direction bitmask grid.
    """
    uf = UnionFind(width * height)
    grid = np.zeros((height, width), dtype=np.uint8)

    edges: List[Tuple[int, int, bool]] = []
    for y in range(height):
        for x in range(width):
            if y != 0:
                edges.append((x, y, True))
            if x != 0:
                edges.append((x, y, False))

    if hasattr(rng, "shuffle") and not isinstance(rng, np.random.Generator):
        rng.shuffle(edges)  # reference stream: in-place Fisher-Yates
    else:
        edges = [edges[e] for e in rng.permutation(len(edges))]
    for x, y, up in edges:
        nx, ny = (x, y - 1) if up else (x - 1, y)
        a, b = y * width + x, ny * width + nx
        if not uf.connected(a, b):
            uf.connect(a, b)
            if up:
                grid[y, x] |= 1
                grid[ny, nx] |= 2
            else:
                grid[y, x] |= 4
                grid[ny, nx] |= 8
    return grid


def merge_vertical_walls(grid: np.ndarray) -> List[Tuple[float, float, float]]:
    """Compress closed vertical boundaries into maximal runs
    (`main.rs:397-417`). Returns (grid_line_x, start_cell_y, run_length_cells).

    Reference quirks replicated exactly:
    - column x == 0 (the west boundary) is emitted as one full-height run,
      duplicating the outer boundary wall added later by the scene builder;
    - the trailing run of each column is pushed unconditionally, so
      zero-length runs appear whenever a column ends with an opening. These
      produce degenerate (zero-extent) planes AND still consume material /
      light random rolls in the scene builder — in the reference a
      zero-length run can even spawn a full-size floating light panel
      (`main.rs:467-480` checks run length <= 2, which 0 satisfies).
    """
    height, width = grid.shape
    walls: List[Tuple[float, float, float]] = []
    for x in range(width):
        wall_start = 0
        wall_height = 0
        for y in range(height):
            if x == 0:
                wall_height += 1
                continue
            elif (grid[y, x] & 4) == 0 and (grid[y, x - 1] & 8) == 0:
                wall_height += 1
            else:
                if wall_height > 0:
                    walls.append((float(x), float(wall_start), float(wall_height)))
                wall_height = 0
                wall_start = y + 1
        walls.append((float(x), float(wall_start), float(wall_height)))
    return walls


def merge_horizontal_walls(grid: np.ndarray) -> List[Tuple[float, float, float]]:
    """Horizontal-run twin of merge_vertical_walls (`main.rs:419-438`).
    Returns (grid_line_y, start_cell_x, run_length_cells)."""
    height, width = grid.shape
    walls: List[Tuple[float, float, float]] = []
    for y in range(height):
        wall_start = 0
        wall_length = 0
        for x in range(width):
            if y == 0:
                wall_length += 1
                continue
            elif (grid[y, x] & 1) == 0 and (grid[y - 1, x] & 2) == 0:
                wall_length += 1
            else:
                if wall_length > 0:
                    walls.append((float(y), float(wall_start), float(wall_length)))
                wall_length = 0
                wall_start = x + 1
        walls.append((float(y), float(wall_start), float(wall_length)))
    return walls
