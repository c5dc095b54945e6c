"""A test-only size of each cell, small enough for the CPU: the cell's own
configuration file and mix with the maze, screen, samples, bounces and call
lengths cut down."""

from __future__ import annotations

from portbench import run, traffic


def bench() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    c = run.load_json(run.PKG / "configs" / f"{name}.json")
    e = c["engine"]
    e["maze"].update(width=4, height=4)
    e["screen"].update(width=64, height=64, samples_per_pixel=4)
    e["tracer"].update(block_rows=1, bounce_limit=2, mirror_limit=3)
    return c


def mix(name: str) -> dict:
    m = traffic.load(name, run.PKG)
    m.update(frames_per_call=4, warmup=[["idle", 8]], cycle_frames=4, run_frames=[4, 4])
    return m


# A test-only mix through the same loop in which the camera walks and turns,
# so that the checks also cover the turn path (yaw, permutation, cursor) and
# the whole screen after it.
TURNING = "turning"
MIXES = {TURNING: dict(loop="scan", frames_per_call=4,
                       warmup=[["idle", 2], ["walk", 2], ["look", 2], ["walk_look", 2]],
                       cycle_frames=40, mix=dict(idle=0.3, walk=0.4, look=0.1, walk_look=0.2),
                       run_frames=[3, 6], keys_held=[1, 2], mouse_dx=[1, 32])}
PLANS = {TURNING: dict(calls=["start", "last_turn", "last"], regions=None,
                       limits=dict(state_mismatch=0, pose_gap=1e-4, pixel_off_share=1e-3,
                                   pixel_max_gap=8))}


def run_tiny(cell_name: str, seed: int = 7, seconds: float = 0.5, trace: bool = False) -> dict:
    """One run of the cell (or of ``interactive`` under a test-only mix) at
    the test size on the CPU, the harness's look for a card left out."""
    b = bench()
    if cell_name in MIXES:
        cell, m = dict(name=cell_name, config="interactive", chips=1), MIXES[cell_name]
    else:
        cell = run.cell_of(b, cell_name)
        m = mix(cell["traffic"])
    return run.run_cell(b, cell, seed, seconds, trace, "cpu", cfg_file=config(cell["config"]),
                        mix=m)


def plan(cell_name: str) -> dict:
    if cell_name in PLANS:
        return PLANS[cell_name]
    return run.load_json(run.PKG / "limits" / f"{cell_name}.json")


def correct(rec: dict, cell_name: str, numbers: dict) -> bool:
    limits = plan(cell_name)["limits"]
    return all(numbers[k] <= limits[k] for k in limits)


# Every cell of BENCHMARK.json, those added later too, and the turning mix.
CELLS = tuple(w["name"] for w in bench()["workloads"]) + (TURNING,)
