"""The engine's state, frame after frame, worked out from the seed and the
inputs alone: everything but the screen. Per frame (the reference app's
order): pop the next window of the chunk queue (Morton-sorted where the
configuration says so), move the camera by its WASD keys in the camera's
frame and take the move back where the player's box meets a wall's box,
split the key and draw the frame's keys, and on a frame that turns apply
the yaw and draw the queue afresh for the next frame.

The pose is computed in ``dtype`` on the CPU (float32 as the configurations
state; the control's lower precision below it), the queue and keys exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .frame import dot, normalize, rotate, sqrt
from .scene import morton2

PI_F32 = float(np.float32(np.pi))


class Frame(NamedTuple):
    """What frame ``number`` of the run draws and leaves."""
    number: int
    ids: torch.Tensor        # [n] int64 window, in ray order
    center: torch.Tensor     # [3] after the move
    quat: torch.Tensor       # [4] after the turn
    half_theta: torch.Tensor
    cursor: int              # after the pop (and the turn)
    key: tuple               # the state's key after the frame
    jkey: tuple
    tkey: tuple              # the threefry key of the frame's trace
    seed: int                # the fused tracer's seed, drawn from tkey
    perm_from: tuple | None  # the key the queue in force after it was drawn from


def rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn in float64, rounded once to x's dtype."""
    return fn(x.double()).to(x.dtype)


def from_look_dir(look: torch.Tensor) -> torch.Tensor:
    default = torch.tensor([0.0, 0.0, 1.0], dtype=look.dtype)
    look_n = normalize(look)
    axis = torch.stack([default[1] * look_n[2] - default[2] * look_n[1],
                        default[2] * look_n[0] - default[0] * look_n[2],
                        default[0] * look_n[1] - default[1] * look_n[0]])
    mag = sqrt(dot(axis, axis))
    axis_n = axis / torch.where(mag > 0, mag, torch.ones_like(mag))
    half = rounded(torch.asin, mag) / 2.0
    return torch.cat([axis_n * rounded(torch.sin, half), rounded(torch.cos, half)[None]])


class Engine:
    """The state of a run of ``cfg`` at ``seed`` on ``scene``'s walls."""

    def __init__(self, cfg: dict, seed: int, scene, dtype=torch.float32, device="cpu"):
        sc, cam = cfg["screen"], cfg["camera"]
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.total = (sc["width"] // sc["chunk_width"]) * (sc["height"] // sc["chunk_width"])
        self.chunks_x = sc["width"] // sc["chunk_width"]
        per = sc["chunks_per_frame"]
        ppc = sc["chunk_width"] ** 2
        self.n = per if per is not None else max(
            1, (sc["width"] // (2 * ppc)) * (sc["height"] // (2 * ppc)))
        f = lambda v: torch.tensor(v, dtype=torch.float32).to(dtype)
        step = cam["move_speed"] / sc["fps"]
        self.right, self.fwd = f((step, 0.0, 0.0)), f((0.0, 0.0, step))
        self.half_extent = f(cam["player_half_extent"])
        self.leaf_min, self.leaf_max = f(scene.leaf_min), f(scene.leaf_max)
        self.sens = float(np.float32(cam["mouse_sensitivity"]))
        pkey, self.key = prng.split(prng.key_of(seed & prng.MASK))
        self.perm_from = pkey
        self.center = f(cam["spawn"])
        self.quat = from_look_dir(f(cam["look_dir"]))
        self.half_theta = rounded(torch.acos, self.quat[3])
        self.cursor, self.frame = 0, 0
        self._perms: dict = {}

    def perm(self, key: tuple) -> torch.Tensor:
        """The queue drawn from ``key`` (int64 [C]), cached."""
        if key not in self._perms:
            self._perms = {key: prng.permutation(key, self.total, self.device)}
        return self._perms[key]

    def window(self, perm: torch.Tensor) -> torch.Tensor:
        pos = (self.cursor + torch.arange(self.n, device=perm.device)) % self.total
        ids = perm[pos]
        if self.cfg["screen"]["sort_chunk_window"]:
            ids = ids[torch.argsort(morton2(ids % self.chunks_x, ids // self.chunks_x),
                                    stable=True)]
        return ids

    def advance(self, keys, mouse_dx: float, rotate_frame: bool, with_ids: bool) -> Frame:
        """One frame on inputs ``keys`` (a, s, d, w as 0/1) and ``mouse_dx``;
        the window's ids are drawn only ``with_ids`` (an empty tensor
        otherwise)."""
        ids = self.window(self.perm(self.perm_from)) if with_ids else torch.zeros(0)
        self.cursor = (self.cursor + self.n) % self.total
        if any(keys):
            # With no key held the move is a sum of signed zeros, which
            # leaves the centre as it is, and so does its collision test.
            a, s, d, w = (torch.tensor(float(k), dtype=torch.float32).to(self.dtype)
                          for k in keys)
            right, fwd = rotate(self.right, self.quat), rotate(self.fwd, self.quat)
            moved = self.center + (((-right * a - fwd * s) + right * d) + fwd * w)
            lo, hi = moved - self.half_extent, moved + self.half_extent
            hit = ((lo <= self.leaf_max) & (hi >= self.leaf_min)).all(dim=-1).any()
            self.center = self.center if bool(hit) else moved
        rkey, self.key = prng.split(self.key)
        self.frame += 1
        jkey, tkey = prng.split(prng.fold_in(self.key, self.frame))
        if rotate_frame:
            dx = torch.tensor(float(np.float32(mouse_dx)), dtype=torch.float32).to(self.dtype)
            x = self.half_theta - dx * self.sens
            r = torch.fmod(x, PI_F32)
            half = torch.where((r < 0) & (r != 0), r + PI_F32, r)
            xyz = self.quat[:3]
            ratio = rounded(torch.sin, half) / sqrt(dot(xyz, xyz))
            cand = torch.cat([xyz * ratio, rounded(torch.cos, half)[None]])
            self.half_theta = half
            if bool(torch.isfinite(cand).all()):
                self.quat, self.perm_from, self.cursor = cand, rkey, 0
        return Frame(self.frame, ids, self.center, self.quat, self.half_theta, self.cursor,
                     self.key, jkey, tkey, prng.tracer_seed(tkey), self.perm_from)


def run(engine: Engine, script, want: set) -> dict:
    """Step ``engine`` through ``script`` (a list of (keys, mouse_dx,
    rotates)); returns {frame number: Frame} of the frame numbers in
    ``want`` (1-based; 0 is the state before the first frame)."""
    out = {}
    if 0 in want:
        out[0] = Frame(0, torch.zeros(0), engine.center, engine.quat, engine.half_theta,
                       engine.cursor, engine.key, None, None, 0, engine.perm_from)
    for keys, dx, rot in script:
        f = engine.advance(keys, dx, rot, engine.frame + 1 in want)
        if f.number in want:
            out[f.number] = f
    return out

