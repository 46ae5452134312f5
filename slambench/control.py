"""The readings that the check's limits are set from, on the card.

    python3 slambench/control.py --workload <cell> --seconds <s> \
        --seeds <n,n,...> [--control-seeds <n,n,...>] [--out <file>]

runs the cell once per seed in one process (the kernels built and loaded
once) with a window of ``--seconds`` at the cell's own load and sizes,
and prints, per seed, every compared number of the program. For each
``--control-seeds`` seed it also prints the control's: the reference put
in the program's place one precision lower (``check.compare`` with
``control=True``). The last line holds, per number, the largest program
reading (the lower reading) and the smallest control reading (the upper
reading). The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from slambench import check, harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="slambench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    rows = []
    for seed in seeds + sorted(control_seeds - set(seeds)):
        t0 = time.time()
        out = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                               control=seed in control_seeds)
        row = {"seed": seed, "correct": out["correct"],
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "n": {k: v["n"] for k, v in out["checks"].items()},
               "ate_m": out["ate_m"], "metrics": out["metrics"],
               "wall_s": time.time() - t0}
        if seed in seeds:
            for k, v in row["program"].items():
                lower[k] = max(lower.get(k, v), v)
        if "control" in out:
            row["control"] = {k: v[0] for k, v in out["control"].items()}
            for k, v in row["control"].items():
                upper[k] = min(upper.get(k, v), v)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seconds": args.seconds,
               "lower": lower, "upper": upper, "numbers": check.NUMBERS}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
