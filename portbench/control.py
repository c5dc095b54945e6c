"""The readings the limits of ``correct`` are set from, on the card, in one
process for many seeds:

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed it runs the cell for a short window (as portbench/run.py does,
untraced) and prints one JSON line with the numbers of the program against
the plain reference (``program``), and with the control's: the reference
itself in bfloat16, the precision below the float32 the configurations
state, put in the program's place and held against the float32 reference
(``control``). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA card", file=sys.stderr)
        return 2
    plan = run.load_json(run.PKG / "limits" / f"{cell['name']}.json")
    for seed in args.seeds:
        rec = run.run_cell(bench, cell, seed, args.seconds, False, "cuda",
                           t0=time.perf_counter())
        t = time.perf_counter()
        line = dict(workload=cell["name"], seed=seed, frames=rec["frames"],
                    program=run.check_numbers(rec, plan))
        line["reference_s"] = time.perf_counter() - t
        t = time.perf_counter()
        line["control"] = run.check_numbers(rec, plan, control=torch.bfloat16)
        line["control_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
