"""The benchmark's own tests, on the CPU: what a run imports, that every
entry of BENCHMARK.json resolves, that a new workload file runs as it is,
the frozen generator's bytes, and a rehearsal of each cell at a tiny size
through the harness's test-only ``rehearsal`` argument, which the command
line does not take."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from slambench import harness, traffic

ROOT = harness.ROOT
BENCH = harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# A tiny rehearsal: the first scans of the log, a short prefix and window,
# a small loop-detector window so the plain versions finish on the CPU.
TINY = {
    "device": "cpu",
    "settings": {"LoopDetectorBranchBound.ScanMatcher.SearchRangeX": 0.3,
                 "LoopDetectorBranchBound.ScanMatcher.SearchRangeY": 0.3,
                 "LoopDetectorBranchBound.ScanMatcher.SearchRangeTheta": 0.1},
    "scans": 260, "prefix_scans": 150, "warmup_scans": 20,
}
CELLS = ("aces-bbfront.online",)
# sha256 of the CARMEN text of each configuration's log at seed 0, with
# the laps of its cell (traffic.py, the frozen generator, as io/synth.py
# at commit 8e18ecb writes it).
LOG_SHA256 = {
    "aces-bbfront.online":
        "15b498dedb7b325fcb37c55c21f08c835c5c0557b76cae314adcf33d9d0929ae",
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(BENCH, "reference")
    frozen = [os.path.join(ref_dir, f) for f in os.listdir(ref_dir)
              if f.endswith(".py")] + [
        os.path.join(BENCH, f) for f in ("traffic.py", "roofline.py",
                                         "ate.py", "check.py")]
    for path in frozen:
        names = set(_imports(path))
        assert names <= {"__future__", "math", "typing", "numpy", "torch",
                         "slambench", "dataclasses", "sys"}, (path, names)


def test_no_module_imports_jax():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(dirpath, f)))
                assert not names & set(harness.FORBIDDEN), (f, names)


def test_benchmark_entries_resolve():
    bench = _bench()
    assert bench["command"] == ["python3", "slambench/run.py"]
    assert bench["paths"] == ["slambench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert c["file"].startswith("slambench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["source"] == c["source"] and len(c["source"]) <= 200
        assert data["reduced"] == c["reduced"] == []
        assert os.path.exists(os.path.join(BENCH, "configs",
                                           data["settings"]))
    names = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        cell = harness.Cell(w["name"])
        assert cell.workload["config"] == w["config"]
        names.add(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        assert callable(harness.Cell(CELLS[0]).reader(m["name"])), path
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                         "device_trace")
    moves = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in moves and m["layer"]
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_generator_log_hash(cell):
    c = harness.Cell(cell)
    text, poses, _ = traffic.make_log(c.config["site"], c.config["sensor"],
                                      c.workload["laps"], 0)
    digest = hashlib.sha256(text.encode()).hexdigest()
    assert len(poses) == text.count("\nFLASER")
    assert digest == LOG_SHA256[cell]


def _rehearse(cell, **kw):
    return harness.run_cell(cell, 20250101, 2.0, False, time.time(),
                            rehearsal=TINY, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_rehearsal_prints_the_result_line(cell, capsys):
    out = _rehearse(cell)
    harness.print_result(out)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"keyframe_p95_ms", "setup_s"}
    assert line["device"]["platform"] == "cpu"


def test_new_workload_file_runs_without_other_edits(tmp_path):
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    wdir = tmp_path / "slambench" / "workloads"
    with open(wdir / (CELLS[0] + ".json")) as f:
        w = json.load(f)
    w["laps"] = 1
    with open(wdir / "aces-bbfront.lap1.json", "w") as f:
        json.dump(w, f)
    out = harness.run_cell("aces-bbfront.lap1", 7, 2.0, False, time.time(),
                           root=str(tmp_path),
                           bench_dir=str(tmp_path / "slambench"),
                           rehearsal=TINY)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"keyframe_p95_ms", "setup_s"}


def test_command_takes_no_rehearsal_and_needs_a_card():
    run = os.path.join(BENCH, "run.py")
    proc = subprocess.run(
        [sys.executable, run, "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0 and not proc.stdout.strip()
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, run, "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from slambench import harness\n"
        "from slambench.tests.test_slambench_harness import TINY\n"
        "harness.run_cell(%r, 3, 1.0, False, time.time(), rehearsal=TINY)\n"
        "print(json.dumps(harness.forbidden_modules()))\n" % (ROOT, CELLS[0]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_trace_attributes_kernels_to_the_open_range(tmp_path):
    from slambench import probes
    from slambench import trace as trace_mod
    spans = probes.Spans()
    main, other = 11, 22
    # Host ranges (perf_counter ns); the trace's clock is microseconds
    # offset by 1000 from them.
    spans.records = [("frontend.match", main, 1_000_000, 3_000_000),
                     ("map_update", main, 3_000_000, 6_000_000),
                     ("backend.detect", other, 2_000_000, 4_000_000)]

    def rt(name, tid, ts, corr, dur=1.0):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid,
                "ts": ts, "dur": dur, "args": {"correlation": corr}}

    def k(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "tid": 7,
                "ts": ts, "dur": dur, "args": {"correlation": corr}}

    events = [rt("cudaDeviceSynchronize", 900, 999.0, 1),
              rt("cudaLaunchKernel", 900, 2100.0, 2),
              k("void window_scores_kernel<1>(float const*)", 2200.0, 500.0,
                2),
              rt("cudaLaunchKernel", 555, 2500.0, 3),
              k("greedy_cost_kernel<1>", 3000.0, 100.0, 3),
              rt("cudaLaunchKernel", 900, 4000.0, 4),
              k("indexing_backward_kernel", 4100.0, 1000.0, 4),
              rt("cudaDeviceSynchronize", 900, 6999.0, 5)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace_mod.summarize(str(path), spans, main, (1_000_000, 7_000_000))
    assert s.window_s == pytest.approx(6000e-6)
    assert s.device_s["frontend.match"] == pytest.approx(500e-6)
    assert s.device_s["backend.detect"] == pytest.approx(100e-6)
    assert s.device_s["map_update"] == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(1600e-6)
    assert s.kernel_seconds("window_scores_kernel") == pytest.approx(500e-6)
    gaps = dict(s.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(4400e-6)
    assert set(gaps) <= {"frontend.match", "map_update", "backend.detect",
                         "other"}
