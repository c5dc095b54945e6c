"""The threefry kernel's erf_inv (its ERFINV output) against the plain
version on every float32 pattern in [-1, 1], on the card.

    python -m mirror_maze_tpu_torch.tools.erf_inv_check [--stride S]

Two checks over the 2,130,706,434 patterns of [+0, 1] and [-0, -1] (every
S-th with ``--stride``):

(a) the step check (ops/prng.py ``erf_inv_steps``): on the float64 route's
    chain, at each of erf_inv's 37 FMA steps, the patterns where a native
    fmaf would differ from ``prng.fma``, and those where the all-native
    route that csrc/threefry.cu's outputs take differs from the float64
    route. It names the step to look at when (b) fails;
(b) the whole output: ``prng.erf_inv`` (one launch a slice of the patterns)
    bitwise ``prng.erf_inv_plain`` on the card, slice by slice.

Prints a line and a JSON line of the counts, and exits non-zero if a step,
the native route or an output differs anywhere. Needs the card: the kernel
is what is checked.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..ops import prng

# Patterns a slice of the whole-output check (1 GiB of float32 at a time).
SLICE = 1 << 26


def patterns(first: int, end: int, stride: int, device) -> torch.Tensor:
    """The float32 patterns first, first + stride, ... below end."""
    bits = torch.arange(first, end, stride, dtype=torch.int64, device=device)
    return bits.to(torch.int32).view(torch.float32) if first < 2 ** 31 else \
        (bits - 2 ** 32).to(torch.int32).view(torch.float32)


def check(stride: int = 1, device=None) -> dict:
    """Both checks over every ``stride``-th pattern of [-1, 1] on ``device``
    (None = the card): {"patterns", "steps" (count a step),
    "native_differs" (patterns whose all-native route differs from the
    float64 route), "output_differs" (patterns where prng.erf_inv differs
    from the plain version)}."""
    dev = torch.device("cuda" if device is None else device)
    counts = torch.zeros(prng.ERF_INV_STEPS + 1, dtype=torch.int64, device=dev)
    total = differ = 0
    for first, end in prng.ERF_INV_RANGES:
        n = (end - first + stride - 1) // stride
        counts += prng.erf_inv_steps(first, n, stride, dev)
        total += n
        for lo in range(first, end, SLICE * stride):
            x = patterns(lo, min(end, lo + SLICE * stride), stride, dev)
            got, want = prng.erf_inv(x), prng.erf_inv_plain(x)
            differ += int((got.view(torch.int32) != want.view(torch.int32)).sum())
            del x, got, want
    return dict(patterns=total, steps=counts[:prng.ERF_INV_STEPS].tolist(),
                native_differs=int(counts[-1]), output_differs=differ)


def differing_steps(out: dict) -> list:
    """The steps of a ``check`` result whose native fmaf differs somewhere."""
    return [s for s, c in enumerate(out["steps"]) if c]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stride", type=int, default=1, help="check every S-th pattern")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("erf_inv_check needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = check(args.stride)
    bad = differing_steps(out)
    print(f"[erf_inv] {out['patterns']} patterns of [-1, 1] (stride {args.stride}): steps whose "
          f"native fmaf differs somewhere {bad}; the native route against the float64 route: "
          f"{out['native_differs']} differ; prng.erf_inv against erf_inv_plain: "
          f"{out['output_differs']} differ; {time.perf_counter() - t0:.1f} s | "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(json.dumps(out))
    return 0 if not bad and not out["native_differs"] and not out["output_differs"] else 1


if __name__ == "__main__":
    sys.exit(main())
