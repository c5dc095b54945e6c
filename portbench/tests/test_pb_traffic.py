"""The traffic generator: the same script for the same seed, the same runs
for every seed, and the mix's stated shares, on a mix of walking and looking
runs of the generator's every kind."""

import itertools
from collections import Counter

from portbench import run, traffic

MIX = dict(loop="scan", frames_per_call=1, warmup=[["idle", 8], ["walk", 8], ["look", 8]],
           cycle_frames=1200, mix=dict(idle=0.3, walk=0.4, look=0.1, walk_look=0.2),
           run_frames=[30, 120], keys_held=[1, 2], mouse_dx=[1, 32])
KIND_OF = {(False, False): "idle", (True, False): "walk", (False, True): "look",
           (True, True): "walk_look"}


def kind(frame) -> str:
    keys, dx, _ = frame
    return KIND_OF[(any(keys), dx != 0.0)]


def window(mix, seed, frames):
    calls = itertools.islice(traffic.Script(mix, seed).window(), frames // mix["frames_per_call"])
    return [f for c in calls for f in c]


def test_a_script_is_the_same_for_the_same_seed_and_differs_across_seeds():
    mix = MIX
    a, b = window(mix, 2 ** 31 + 5, 3600), window(mix, 2 ** 31 + 5, 3600)
    assert a == b
    assert traffic.Script(mix, 2 ** 31 + 5).warmup == traffic.Script(mix, 2 ** 31 + 5).warmup
    assert a != window(mix, 2 ** 31 + 6, 3600)


def test_a_mix_keeps_the_stated_shares_in_every_cycle_for_every_seed():
    mix = MIX
    n = mix["cycle_frames"]
    want = {k: round(s * n) for k, s in mix["mix"].items()}
    for seed in (0, 1, 2 ** 31 + 17):
        frames = window(mix, seed, 3 * n)
        for c in range(3):
            assert Counter(kind(f) for f in frames[c * n:(c + 1) * n]) == want
    # 30% of frames turn, each with |dx| of 1-32 whole pixels held for a run.
    turning = [f for f in window(mix, 3, n) if f[2]]
    assert len(turning) == round(0.3 * n)
    assert all(1 <= abs(f[1]) <= 32 and f[1] == int(f[1]) for f in turning)


def test_every_seed_gets_the_same_runs_in_another_order():
    mix = MIX
    lo, hi = mix["run_frames"]
    runs = traffic.cycle_runs(mix)
    assert all(lo <= n <= hi for _, n in runs)
    assert sum(n for _, n in runs) == mix["cycle_frames"]
    a, b = traffic.Script(mix, 1).cycle(0), traffic.Script(mix, 2).cycle(0)
    assert a != b and sorted(map(kind, a)) == sorted(map(kind, b))


def test_refine_is_idle_calls_of_sixty_frames():
    mix = traffic.load("refine", run.PKG)
    s = traffic.Script(mix, 9)
    calls = list(itertools.islice(s.window(), 3))
    assert [len(c) for c in calls] == [60, 60, 60]
    assert all(f == ((False,) * 4, 0.0, False) for c in calls for f in c)
    assert [len(c) for c in s.warmup_calls()] == [60]
