"""Readings that set a cell's limits: for each seed, one run of the cell
(set-up, a window of ``--seconds``) with the program's numbers against the
reference and the control's, the reference computed in bfloat16 put in the
program's place; each line gives both verdicts under the cell's limits
(``correct``, ``control_correct``: the control has to read false).  The
benchmark's own runs never run the control.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 5 \\
        [--out chiprun_out/readings.jsonl]

One process for all seeds: the set-up is made again for each (the weights
are the seed's), the process start and kernel loading once.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run._env()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           control=not args.no_control)
        line = json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                           "control_correct": out.get("_control_correct"),
                           "readings": out["_readings"], "metrics": out["metrics"],
                           "counters": out["_counters"],
                           "memory_peak_bytes": out["device"]["memory_peak_bytes"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
