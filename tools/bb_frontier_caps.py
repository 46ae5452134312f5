#!/usr/bin/env python3
"""The branch-and-bound frontend settings at several frontier caps.

Usage, on a machine with the card, from the repository root::

    python3 tools/bb_frontier_caps.py [--caps 4096 16384 65536]

Runs ``chip_smoke.py``'s phase 8 (``launcher.run`` on
``configs/launcher_settings_bb_frontend.json``, online, synchronous
backend, over chip_smoke's 2-lap synthetic log) once per cap, with
``Tpu.BranchBoundFrontierCap`` set to the cap and every other setting
unchanged, and prints phase 8's statistics line for each: closures, loop
edges, aligned ATE, scans/s, median keyframe ms, the summed
``frontier_overflow``, the matches in which the per-level quota
(``cap // 4``) dropped live nodes, and the host synchronizations per
keyframe. About a minute per cap on an H100.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "bb_frontier_caps_chip_smoke", os.path.join(THIS, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--caps", type=int, nargs="+",
                        default=[4096, 16384, 65536])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bb_frontier_caps: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, THIS)
    from my_lidar_graph_slam_tpu_torch.ops.cuda import loader

    cs = _chip_smoke()
    settings = cs.BB_FRONTEND
    dev = torch.device("cuda")
    loader.build_all()
    with tempfile.TemporaryDirectory(dir=THIS, prefix="bb_caps_") as work:
        cs.slice_log(work)
        for cap in args.caps:
            with open(settings) as f:
                tree = json.load(f)
            tree.setdefault("Tpu", {})["BranchBoundFrontierCap"] = cap
            path = os.path.join(work, f"bb_frontend_cap{cap}.json")
            with open(path, "w") as f:
                json.dump(tree, f)
            cs.BB_FRONTEND = path
            stats, _ = cs.phase_bb_frontend(torch, dev, work)
            print(json.dumps({"frontier_cap": cap, **stats}), flush=True)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
