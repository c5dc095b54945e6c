"""What the plain reference expects of a run, and how a run's outputs are
held against it.

A run is the configuration, the seed and the script of every frame it
stepped (warm-up and window). A check names a call of that run: the frames
it stepped, the state the program handed in and the state and display
frame it handed back. The reference works out every frame's queue, keys and
pose from the seed (``sim``); the screen it can only follow from the state
the program handed in, since every frame's blur spreads each pixel over its
neighbours. So for a call of F frames it takes the handed-in screen over
square regions drawn from the seed, widened by F pixels, traces every chunk
of the widened region that each frame refreshes, resolves it in, blurs and
quantizes, and after F frames holds the regions exact; with ``regions``
None the region is the whole screen. The scene and the rays' light are the
configuration's reference route's (``"reference"`` in its file: the module
``portbench/reference/<route>.py``, see ``__init__.py``); nothing else here
knows how a ray is traced.

``compare`` gives the numbers that decide ``correct``:

- ``state_mismatch``: entries of the queue, cursor, key and frame counter
  that differ, over every state checked;
- ``pose_gap``: the largest gap of the camera centre, quaternion and yaw
  half-angle over those states;
- ``pixel_off_share``: the share of the display values compared (the
  state's screen as displayed, and the display frame the call fetched) that
  differ by more than 1 of 255;
- ``pixel_max_gap``: the largest of those gaps, of 255.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from . import frame as fr
from . import route_module, sim

STATE_FIELDS = ("cam_center", "quat", "half_theta", "perm", "cursor", "key", "frame")


def route_of(cfg_file: dict):
    """The reference route module that a configuration file names
    (``"reference"``); a ValueError naming it where there is none such."""
    route = importlib.import_module(route_module(cfg_file))
    if not all(callable(getattr(route, f, None)) for f in ("build", "trace")):
        raise ValueError(f"reference route {cfg_file['reference']!r}: {route.__name__} has no "
                         "build() and trace()")
    return route


def regions_of(cfg: dict, seed: int, count: int, side: int) -> list:
    """``count`` squares of ``side`` chunks, (cx0, cy0, cx1, cy1), drawn from
    the seed over the chunk grid."""
    s = cfg["screen"]
    cx, cy = s["width"] // s["chunk_width"], s["height"] // s["chunk_width"]
    side = min(side, cx, cy)
    rng = np.random.default_rng([seed, 0x5EED])
    x0 = rng.integers(0, cx - side + 1, count)
    y0 = rng.integers(0, cy - side + 1, count)
    return [(int(a), int(b), int(a) + side, int(b) + side) for a, b in zip(x0, y0)]


def state_of(f: sim.Frame, engine: sim.Engine) -> dict:
    """The reference's state after frame ``f`` as NumPy arrays."""
    return dict(cam_center=f.center.float().numpy(), quat=f.quat.float().numpy(),
                half_theta=f.half_theta.float().numpy(),
                perm=engine.perm(f.perm_from).numpy().astype(np.int32),
                cursor=np.int32(f.cursor), key=np.array(f.key, np.int64),
                frame=np.int32(f.number))


def _spatial(cm: torch.Tensor, cfg: dict) -> torch.Tensor:
    s = cfg["screen"]
    cw = s["chunk_width"]
    cy, cx = s["height"] // cw, s["width"] // cw
    return cm.reshape(cy, cx, cw, cw, 3).permute(0, 3, 1, 2, 4).reshape(s["height"],
                                                                         s["width"], 3)


class Reference:
    """The reference of one run of the configuration file ``cfg_file``: its
    route's scene, and its engine stepped through the run's script, in
    ``dtype`` (float32; lower for the control)."""

    def __init__(self, cfg_file: dict, seed: int, script: list, device,
                 dtype=torch.float32):
        self.route = route_of(cfg_file)
        self.cfg, self.seed, self.script = cfg_file["engine"], seed, script
        self.device, self.dtype = torch.device(device), dtype
        # Elements of one [rays, records] intermediate a route holds at once.
        self.budget = 1 << 26 if self.device.type == "cuda" else 1 << 23
        # Float32 products stay float32 on the card (the tie sums of the
        # nearest-hit select are a matrix product).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.scene = self.route.build(self.cfg, device)

    def frames(self, want: set) -> tuple:
        engine = sim.Engine(self.cfg, self.seed, self.scene, self.dtype)
        return sim.run(engine, self.script, want), engine

    def expect(self, checks: list) -> tuple:
        """(per check {"before", "after": state dicts, "display": uint8
        [h, w, 3] of each region, "regions": the regions}, the state after
        the script's last frame). A check is a dict of "first" (frames
        stepped before the call), "frames" (F), "screen" (the chunk-major
        screen handed in, on any device) and "regions" (None, or (count,
        side))."""
        last = len(self.script)
        want = {0, last}
        for c in checks:
            want |= set(range(c["first"], c["first"] + c["frames"] + 1))
        frames, engine = self.frames(want)
        final = state_of(frames[last], engine)
        out = []
        for c in checks:
            first, n = c["first"], c["frames"]
            regions = self.regions(c)
            out.append(dict(before=state_of(frames[first], engine),
                            after=state_of(frames[first + n], engine),
                            regions=regions,
                            display=self.follow(c["screen"], [frames[first + i + 1]
                                                              for i in range(n)],
                                                engine, regions)))
        return out, final

    def work(self, numbers: list, chunks: int) -> tuple:
        """The route's statistics of ``chunks`` chunks drawn from the seed
        out of the windows of frames ``numbers``, and the share of those
        frames' rays they hold: (stats, sampled rays, rays)."""
        s = self.cfg["screen"]
        cw, spp, ppc = s["chunk_width"], s["samples_per_pixel"], s["chunk_width"] ** 2
        frames, _ = self.frames(set(numbers))
        rng = np.random.default_rng([self.seed, 0x0B5])
        stats, sampled, total = {}, 0, 0
        for n in numbers:
            f = frames[n]
            ids = f.ids.to(self.device)
            k = torch.from_numpy(rng.choice(ids.numel(), min(chunks, ids.numel()),
                                            replace=False)).to(self.device)
            pix = fr.chunk_pixels(ids[k] % (s["width"] // cw), ids[k] // (s["width"] // cw), cw)
            index = (k[:, None] * ppc + torch.arange(ppc, device=self.device)).reshape(-1)
            center = f.center.to(self.device)
            ori, dirs, ray_ids = fr.rays(self.cfg, center, f.quat.to(self.device), pix, index,
                                         f.jkey, self.dtype)
            self.route.trace(self.scene, ori, dirs, ray_ids, [(f, ray_ids.numel())],
                             center.float(), self.cfg["tracer"], self.dtype, self.budget,
                             stats=stats)
            sampled += ray_ids.numel()
            total += ids.numel() * ppc * spp
        return stats, sampled, total

    def regions(self, check: dict) -> list:
        s = self.cfg["screen"]
        if check["regions"] is None:
            cw = s["chunk_width"]
            return [(0, 0, s["width"] // cw, s["height"] // cw)]
        count, side = check["regions"]
        return regions_of(self.cfg, self.seed + check["first"], count, side)

    def follow(self, screen_cm: torch.Tensor, steps: list, engine, regions: list) -> list:
        """The display values of ``regions`` after ``steps`` from the
        chunk-major screen ``screen_cm``."""
        s, tc = self.cfg["screen"], self.cfg["tracer"]
        cw, spp, ppc = s["chunk_width"], s["samples_per_pixel"], s["chunk_width"] ** 2
        cxn, cyn = s["width"] // cw, s["height"] // cw
        margin = -(-len(steps) // cw)
        spatial = _spatial(screen_cm.to(self.device), self.cfg)
        patches = []
        for cx0, cy0, cx1, cy1 in regions:
            box = (max(0, cx0 - margin), max(0, cy0 - margin), min(cxn, cx1 + margin),
                   min(cyn, cy1 + margin))
            patches.append([box, spatial[box[1] * cw:box[3] * cw,
                                         box[0] * cw:box[2] * cw].to(self.dtype).clone()])
        del spatial
        # The rays of every step first (they do not depend on the screen),
        # traced together where the camera stands still; then the steps in
        # order: resolve, scatter, present.
        work = []
        for i, f in enumerate(steps):
            ids = f.ids.to(self.device)
            cx, cy = ids % cxn, ids // cxn
            # Frame i's scatter is followed by F - i blurs: only chunks within
            # that many pixels of a region reach it.
            reach = -(-(len(steps) - i) // cw)
            parts = []
            for p, (rx0, ry0, rx1, ry1) in enumerate(regions):
                k = torch.nonzero((cx >= rx0 - reach) & (cx < rx1 + reach)
                                  & (cy >= ry0 - reach) & (cy < ry1 + reach))[:, 0]
                parts.append((p, k))
            k_all = torch.cat([k for _, k in parts])
            pix = fr.chunk_pixels(cx[k_all], cy[k_all], cw)
            index = (k_all[:, None] * ppc + torch.arange(ppc, device=self.device)).reshape(-1)
            ori, dirs, ray_ids = fr.rays(self.cfg, f.center.to(self.device),
                                         f.quat.to(self.device), pix, index, f.jkey, self.dtype)
            work.append(dict(parts=parts, pix=pix, ori=ori, dirs=dirs, ray_ids=ray_ids, frame=f,
                             anchor=tuple(f.center.float().tolist())))
        lights = [None] * len(work)
        for anchor in dict.fromkeys(w["anchor"] for w in work):
            group = [i for i, w in enumerate(work) if w["anchor"] == anchor]
            cat = lambda key: torch.cat([work[i][key] for i in group])
            light = self.route.trace(self.scene, cat("ori"), cat("dirs"), cat("ray_ids"),
                                     [(work[i]["frame"], work[i]["ray_ids"].numel())
                                      for i in group],
                                     torch.tensor(anchor, device=self.device), tc, self.dtype,
                                     self.budget)
            for i, part in zip(group, light.split([work[i]["ray_ids"].numel() for i in group])):
                lights[i] = part
        for w, light in zip(work, lights):
            colors = fr.resolve(light, spp, self.dtype)
            at = 0
            for p, k in w["parts"]:
                n = k.numel() * ppc
                (bx0, by0, _, _), patch = patches[p]
                xy = w["pix"][at:at + n]
                patch[xy[:, 1] - by0 * cw, xy[:, 0] - bx0 * cw] = colors[at:at + n]
                at += n
            for p in patches:
                p[1] = fr.present(p[1])
        out = []
        for (cx0, cy0, cx1, cy1), ((bx0, by0, _, _), patch) in zip(regions, patches):
            y, x = (cy0 - by0) * cw, (cx0 - bx0) * cw
            out.append(fr.to_display(patch[y:y + (cy1 - cy0) * cw,
                                           x:x + (cx1 - cx0) * cw]).cpu().numpy())
        return out


def program_state(state) -> dict:
    """An engine state of the program (any object with the state's fields
    as tensors) as NumPy arrays, the screen left out."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}


def program_regions(cfg: dict, screen_cm: torch.Tensor, display, regions: list) -> list:
    """Per region, the display values [2, h, w, 3] of the program's screen
    and of its fetched display frame (uint8 [H, W, 3], or None)."""
    cw = cfg["screen"]["chunk_width"]
    spatial = fr.to_display(_spatial(screen_cm, cfg)).cpu().numpy()
    out = []
    for cx0, cy0, cx1, cy1 in regions:
        sl = (slice(cy0 * cw, cy1 * cw), slice(cx0 * cw, cx1 * cw))
        shown = spatial[sl] if display is None else np.asarray(display)[sl]
        out.append(np.stack([spatial[sl], shown]))
    return out


def compare(expected: list, got: list, final: tuple | None = None) -> dict:
    """The numbers of a run: ``expected`` from ``Reference.expect``, ``got``
    per check {"before", "after": the program's state dicts, "display": its
    regions from ``program_regions``}; ``final`` (reference state, program
    state) of the run's last frame."""
    pairs = [(e[k], g[k]) for e, g in zip(expected, got) for k in ("before", "after")]
    if final is not None:
        pairs.append(final)
    mismatch, pose = 0, 0.0
    for want, have in pairs:
        for k in ("perm", "cursor", "key", "frame"):
            w, h = np.asarray(want[k]).astype(np.int64), np.asarray(have[k]).astype(np.int64)
            mismatch += int(w.size) if w.shape != h.shape else int((w != h).sum())
        for k in ("cam_center", "quat", "half_theta"):
            gap = np.abs(np.asarray(want[k], np.float64) - np.asarray(have[k], np.float64))
            pose = max(pose, float(np.nan_to_num(gap, nan=np.inf).max()))
    off = values = 0
    worst = 0
    for e, g in zip(expected, got):
        for want, have in zip(e["display"], g["display"]):
            gap = np.abs(have.astype(np.int16) - want.astype(np.int16)[None])
            off += int((gap > 1).sum())
            values += gap.size
            worst = max(worst, int(gap.max(initial=0)))
    return dict(state_mismatch=mismatch, pose_gap=pose,
                pixel_off_share=off / max(1, values), pixel_max_gap=worst)
