#!/usr/bin/env python3
"""Time the port's two CUDA kernels of this checkout against those of other
checkouts on one card, on the inputs the main path gives them.

Usage, on a machine with the card, from the repository root::

    # into any git-ignored directory of the checkout:
    git archive <commit> | tar -x -C _archive_check/other
    python3 tools/kernel_ab.py _archive_check/other [OTHER ...]

First one process of this checkout runs phase 4 of ``chip_smoke.py`` (the
slice, with its recorders) and saves the arguments of the slice's last call
at each shape of each kernel: K1 (``window_scores``) and K2
(``greedy_cost_core``) at the frontend (Q=1) and at detection (Q=1/2/4).
Then, for each other checkout, four fresh processes in turn, OTHER, THIS,
THIS, OTHER: each builds its checkout's kernels from that checkout's
``csrc/``, calls them through that checkout's wrappers on the saved inputs,
holds them against the plain versions (K1 within chip_smoke's tolerance, K2
bit-equal) and times them with chip_smoke's timers: back to back (``ms``,
as chip_smoke's ``ms``), queued (``ms_queued``, the device's time), alone
after a cold L2, and the host's time per call while the card is busy.
Prints the slice's statistics, one JSON line per process, and for each
other checkout a JSON summary in which each number is the mean of a side's
two runs. About 2 minutes for the recording and 1 per other checkout.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("host_ms", "ms", "ms_queued", "cold_ms")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_chip_smoke", os.path.join(THIS, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(path: str) -> None:
    """Run the slice with chip_smoke's recorders; save {kernel: {shape:
    (args, kwargs)}} of the last call at each shape to ``path``."""
    import torch

    sys.path.insert(0, THIS)
    cs = _chip_smoke()
    with tempfile.TemporaryDirectory(dir=THIS, prefix="kernel_ab_") as work:
        stats, rec, *_ = cs.phase_slice(torch, torch.device("cuda"), work)
    torch.save({r.name: {f"{p} Q={q}": (list(args), kw)
                         for (p, _, q), (args, kw) in r.calls.items()}
                for r in rec}, path)
    print(json.dumps({"slice": stats}), flush=True)


def host_ms(torch, fn, iters=200):
    """Host time per call of ``fn`` (the wrapper's checks, allocation and
    launch), while the card sleeps so that no call waits for it."""
    import time

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def child(root: str, path: str) -> None:
    import torch

    sys.path.insert(0, root)
    from my_lidar_graph_slam_tpu_torch.ops.cuda import (correlate,
                                                        greedy_cost, loader)
    if not os.path.abspath(loader.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported the port from {loader.__file__}")
    cs = _chip_smoke()
    loader.build_all(["correlate", "greedy_cost"])
    for name, text in getattr(loader, "ptxas_report", {}).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{root} {name}: {line.strip()}", file=sys.stderr)
    saved = torch.load(path, map_location="cuda", weights_only=True)
    kernels = {
        "window_scores": ("window_scores", correlate.window_scores,
                          correlate.window_scores_plain),
        "greedy_cost_core": ("greedy_cost", greedy_cost.greedy_cost_core,
                             greedy_cost.greedy_cost_core_plain)}
    rows = []
    for key, (label, fn, plain) in kernels.items():
        for shape, (args, kw) in sorted(saved[key].items()):
            name = f"{label}[{shape}]"

            def call():
                return fn(*args, **kw)

            got, again, ref = call(), call(), plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two launches differ")
            if key == "window_scores":
                cs.check_k1(name, got, ref, torch)
            elif not torch.equal(got, ref):
                raise AssertionError(f"{name}: not bit-equal to the plain "
                                     "core")
            rows.append({"name": name, "host_ms": host_ms(torch, call),
                         "ms": cs.time_ms(torch, call),
                         "ms_queued": cs.time_ms(torch, call, queued=True),
                         "cold_ms": cs.time_cold_ms(torch, call)})
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "rows": rows}), flush=True)


def _run(args, timeout):
    out = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                         capture_output=True, text=True, timeout=timeout)
    sys.stderr.write(out.stderr[-4000:])
    if out.returncode != 0:
        print(f"kernel_ab: {' '.join(args)} failed", file=sys.stderr)
        return None
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--record":
        record(sys.argv[2])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    others = [os.path.abspath(a) for a in sys.argv[1:]]
    with tempfile.TemporaryDirectory(dir=THIS, prefix="kernel_ab_") as tmp:
        path = os.path.join(tmp, "inputs.pt")
        if _run(["--record", path], timeout=900) is None:
            return 1
        for other in others:
            summary = {}
            for root in (other, THIS, THIS, other):
                run = _run(["--child", root, path], timeout=600)
                if run is None:
                    return 1
                side = "other" if root == other else "this"
                for r in run["rows"]:
                    s = summary.setdefault(r["name"], {})
                    for key in KEYS:
                        s.setdefault(f"{side}_{key}", []).append(r[key])
            for s in summary.values():
                for key in list(s):
                    s[key] = sum(s[key]) / len(s[key])
            print(json.dumps({"other": other, "summary": summary}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
