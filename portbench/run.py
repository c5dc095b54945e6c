"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell (``workloads`` of BENCHMARK.json) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``), which names the loop that drives it
(``portbench/loops/<loop>.py``); its metrics are the entries of
BENCHMARK.json whose ``workloads`` name it, each read by
``portbench/metrics/<metric>.py``; the limits of its check are
``portbench/limits/<cell>.json``. The configuration names its plain
reference's route (``"reference"``: ``portbench/reference/<route>.py``), and
a metric that reads a kernel's roofline names it (``ROOFLINE`` in its
module: ``portbench/roofline/<kernel>.py``).

A run builds the scene and the engine from the seed, steps the mix's
warm-up (every graph the mix uses is captured there), then steps the mix for
``--seconds`` and closes the window after the call that reaches it. With
``--trace 1`` torch.profiler traces the window's second half and the
per-layer metrics are printed instead of the end-to-end ones. Then the
plain reference (``portbench/reference``) checks what the window produced,
the rooflines that the printed metrics read are counted, and the last line
of standard output is one JSON object. With no card, or
fewer than the cell asks for, it exits 2 and prints no result; where the
process holds JAX or the JAX package by the end, it exits 3 and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import loops, traffic  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level modules no process of the benchmark may hold: JAX and the JAX
# package (whose name the port's begins with).
FORBIDDEN = ("jax", "jaxlib", "flax", "mirror_maze_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def engine_config(engine: dict):
    """The port's EngineConfig of a configuration file's ``engine`` group."""
    from mirror_maze_tpu_torch.config import (
        CameraConfig, EngineConfig, MazeConfig, ScreenConfig, TracerConfig)

    def make(cls, values, **extra):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in values.items()},
                   **extra)
    return EngineConfig(maze=make(MazeConfig, engine["maze"]), tracer=make(TracerConfig, engine["tracer"]),
                        camera=make(CameraConfig, engine["camera"]),
                        screen=make(ScreenConfig, engine["screen"]),
                        intersector=engine["intersector"])


class Clock:
    """Synchronize for the run's device."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str,
             cfg_file: dict | None = None, mix: dict | None = None, t0: float = T0) -> dict:
    """Set up, warm up and step one cell for ``seconds`` through its mix's
    loop (``portbench/loops/<loop>.py``); returns the run's record
    (timings, trace, what the checks read), everything the metric readers
    and the reference need."""
    from mirror_maze_tpu_torch import kernels
    from mirror_maze_tpu_torch.render.scenebuf import upload_scene
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.scene.builder import build_scene

    from .reference import route_module

    cfg_file = cfg_file or load_json(PKG / "configs" / f"{cell['config']}.json")
    route_module(cfg_file)      # a route the reference lacks fails before a frame is stepped
    mix = mix or traffic.load(cell["traffic"], PKG)
    loop = loops.find(mix["loop"])
    dev = torch.device(device)
    clock = Clock(dev)
    cfg = engine_config(cfg_file["engine"])

    t = time.perf_counter()
    scene = upload_scene(build_scene(cfg.maze), device=dev)
    clock.sync()
    scene_setup_s = time.perf_counter() - t
    call = loop.make_call(scene, cfg)
    # The engine's key takes the seed's low 32 bits (the port's PRNGKey range).
    run = loops.Run(call=call, state=init_state(cfg, seed=seed & 0xFFFFFFFF, device=dev),
                    script=traffic.Script(mix, seed), clock=clock, seconds=seconds, trace=trace)
    loop.warm_up(run)
    clock.sync()
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = dict(kernels.launches)
    setup_s = time.perf_counter() - t0

    loop.drive(run)
    memory_peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0
    graphs = {}
    for kind, g in getattr(call.runner, "graphs", {}).items():
        graphs[str(kind)] = {k: getattr(g, k) for k in ("replays", "eager_frames", "copies",
                                                        "capture_s", "pool_bytes")
                             if hasattr(g, k)}
    launches = {k: v - launches0.get(k, 0) for k, v in kernels.launches.items()
                if v - launches0.get(k, 0)}
    del call, scene, run.call
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    return dict(cfg_file=cfg_file, seed=seed, device=dev,
                setup_s=setup_s, scene_setup_s=scene_setup_s, window_s=run.window_s,
                frames=run.frames, host_s=run.host_s, host_frames=run.host_frames,
                trace=run.trace_rec, memory_peak_bytes=int(memory_peak), graphs=graphs,
                launches=launches, stepped=run.stepped, checks=run.checks, final=run.state)


def check_numbers(rec: dict, plan: dict, control: torch.dtype | None = None) -> dict:
    """The numbers that decide ``correct``: the program's outputs against the
    plain reference, or, with a ``control`` dtype, the reference computed in
    it against the reference in float32."""
    from .reference import check as ref

    cfg_file = rec["cfg_file"]
    cfg = cfg_file["engine"]
    script = rec["stepped"]
    chosen = [(name, rec["checks"][name]) for name in plan["calls"] if name in rec["checks"]]
    specs = [dict(first=c["first"], frames=c["frames"], screen=c["before"].screen,
                  regions=plan["regions"]) for _, c in chosen]
    reference = ref.Reference(cfg_file, rec["seed"], script, rec["device"])
    expected, final_ref = reference.expect(specs)
    if control is not None:
        low, low_final = ref.Reference(cfg_file, rec["seed"], script, rec["device"],
                                       control).expect(specs)
        got = [dict(before=e["before"], after=e["after"],
                    display=[np.stack([d, d]) for d in e["display"]]) for e in low]
        final = (final_ref, low_final)
    else:
        got = [dict(before=ref.program_state(c["before"]), after=ref.program_state(c["after"]),
                    display=ref.program_regions(cfg, c["after"].screen, c["display"],
                                                e["regions"]))
               for (_, c), e in zip(chosen, expected)]
        final = (final_ref, ref.program_state(rec["final"]))
    return ref.compare(expected, got, final)


def reader(name: str):
    """The reader of metric ``name``: ``portbench/metrics/<quantity>.py``,
    the quantity being the name up to its first dot (a quantity split by the
    end-to-end metric it moves, ``host_ms.<split>``, shares its reader)."""
    return importlib.import_module(f"portbench.metrics.{name.split('.')[0]}")


def roofline(kernel: str):
    """The count of kernel ``kernel``'s work: ``portbench/roofline/<kernel>.py``,
    whose ``work(rec, reference)`` gives at least its ``bound_ms`` a launch."""
    return importlib.import_module(f"portbench.roofline.{kernel}")


def rooflines(bench: dict, cell: dict, rec: dict, kind: str) -> dict:
    """{kernel: its work} of the kernels that the cell's ``kind`` metrics
    name (``ROOFLINE`` in a reader's module), each counted on the plain
    reference of the run's configuration, by its own route; {} where none
    names one."""
    from .reference import check as ref

    kernels = sorted({k for m in metrics_of(bench, cell["name"], kind)
                      if (k := getattr(reader(m["name"]), "ROOFLINE", None))})
    if not kernels:
        return {}
    reference = ref.Reference(rec["cfg_file"], rec["seed"], rec["stepped"], rec["device"])
    return {k: roofline(k).work(rec, reference) for k in kernels}


def read_metrics(bench: dict, cell: str, kind: str, rec: dict) -> dict:
    out = {}
    for m in metrics_of(bench, cell, kind):
        value = reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def kind_of(rec: dict) -> str:
    """The metrics a run prints: ``per_layer`` traced, else ``end_to_end``."""
    return "per_layer" if rec["trace"] is not None else "end_to_end"


def result(bench: dict, cell: dict, rec: dict, numbers: dict, limits: dict) -> dict:
    trace = rec["trace"]
    kind = kind_of(rec)
    dev = rec["device"]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}
    if trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    out = {"correct": all(numbers[k] <= limits[k] for k in limits),
           "attempted": rec["frames"], "failed": 0,
           "metrics": read_metrics(bench, cell["name"], kind, rec), "device": device}
    if trace is not None:
        out["breakdown"] = trace["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    rec = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    return report(bench, cell, rec)


def report(bench: dict, cell: dict, rec: dict) -> int:
    """Check what the window produced against the reference, read the
    metrics and print the result line; exit code 3, and no result, where
    the process holds JAX or the JAX package by then."""
    print(json.dumps({"card": card(), "setup_s": rec["setup_s"],
                      "scene_setup_s": rec["scene_setup_s"], "frames": rec["frames"],
                      "window_s": rec["window_s"], "memory_peak_bytes": rec["memory_peak_bytes"],
                      "host_ms": rec["host_s"] * 1e3 / max(1, rec["host_frames"]),
                      "graphs": rec["graphs"], "launches": rec["launches"]}), file=sys.stderr)
    plan = load_json(PKG / "limits" / f"{cell['name']}.json")
    t = time.perf_counter()
    numbers = check_numbers(rec, plan)
    print(f"portbench: the reference took {time.perf_counter() - t:.1f} s", file=sys.stderr)
    if rec["trace"] is not None:
        print(json.dumps({k: v for k, v in rec["trace"].items() if k != "breakdown"}),
              file=sys.stderr)
    rec["rooflines"] = rooflines(bench, cell, rec, kind_of(rec))
    for kernel, work in rec["rooflines"].items():
        print(json.dumps({f"{kernel}_work": work}), file=sys.stderr)
    out = result(bench, cell, rec, numbers, plan["limits"])
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
