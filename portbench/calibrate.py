"""The readings that the limits of ``correct`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--dtype float32] [--out <file.jsonl>]

runs the cell once per seed in one process, each run with a short window
at the cell's own load and the same check as a benchmark run, and prints
one JSON line per seed with the numbers compared (``r_gap_bp``,
``capital_rel``) and the run's counts.  With ``--dtype float32`` the
program runs one precision below the cell's float64: the control, which
has to read far above the sound runs.  Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import Bench, run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            result, checks, _ = run_cell(bench, args.workload, seed,
                                         args.seconds, False,
                                         dtype_name=args.dtype)
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "dtype": args.dtype or "cell", "attempted":
                result["attempted"], "failed": result["failed"],
                **{k: v for k, (v, _) in checks.items()},
                "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
