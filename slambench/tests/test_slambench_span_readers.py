"""The readers of the program's spans and counters
(``metrics/frontend.*``, ``map_builder.*``, ``backend.detect_ms``) on a
hand-built run: a CPU export of the program's ``MetricManager`` (spans
made through ``MetricManager.span`` under a CPU profiler session, their
times then set by hand) and a stub ``TraceSummary``. Each returns the
number its definition gives, and None without its inputs, as on a
program that has no spans or counters."""

import pytest
import torch

from slambench import harness, roofline
from slambench.trace import TraceSummary

from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

MS = 1_000_000
NEW = ("frontend.sync_wait_ms", "frontend.host_busy_ms",
       "frontend.host_syncs_per_kf", "frontend.lock_wait_ms",
       "frontend.overflowed_match_share", "map_builder.sync_wait_ms",
       "map_builder.host_busy_ms", "map_builder.host_syncs_per_kf",
       "map_builder.raycast_roofline", "backend.detect_ms")


def _read(name, run):
    return harness.Cell("aces-bbfront.online").reader(name)(run)


def _keyframe(kf, durations, match_ms, match_sync_ms, resolve_ms,
              resolve_sync_ms, update_ms, update_sync_ms, lock_ms):
    """One keyframe's spans; each span's duration is appended to
    ``durations`` in the order the spans open, which is their rows'."""
    span = MetricManager.span
    with span("keyframe", keyframe=kf):
        durations.append(100)
        for name, ms, sync_ms in (("lock_wait", lock_ms, None),
                                  ("frontend.match", match_ms,
                                   match_sync_ms),
                                  ("frontend.resolve", resolve_ms,
                                   resolve_sync_ms),
                                  ("map_builder.update", update_ms,
                                   update_sync_ms)):
            with span(name):
                durations.append(ms)
                if sync_ms is not None:
                    with span("sync", site="a site"):
                        durations.append(sync_ms)


@pytest.fixture
def export():
    """The export of three keyframes and two backend passes (a lock wait
    and a detection in the first), each span lasting the milliseconds
    given."""
    MetricManager.reset_instance()
    durations = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _keyframe(10, durations, 4, 1, 6, 5, 8, 2, 0)
        _keyframe(11, durations, 5, 2, 7, 6, 9, 3, 3)
        _keyframe(12, durations, 6, 1, 8, 7, 10, 1, 0)
        with MetricManager.span("backend.pass", keyframe=1):
            durations.append(50)
            with MetricManager.span("lock_wait"):
                durations.append(1)
            with MetricManager.span("backend.detect"):
                durations.append(30)
        with MetricManager.span("backend.pass", keyframe=2):
            durations.append(20)
    counters = MetricManager.instance().counters
    counters("HostSyncs.frontend").increment(27)
    counters("HostSyncs.map_builder").increment(45)
    counters("HostSyncs.backend").increment(4)
    counters("FrontendMatches").increment(3)
    counters("FrontendFrontierOverflowMatches").increment(1)
    counters("MapBuilderRaycastBytes").increment(6.7e9)
    out = MetricManager.instance().to_dict()
    assert len(out["Spans"]) == len(durations)
    for i, (row, ms) in enumerate(zip(out["Spans"], durations)):
        row[2], row[3] = 1000 * i * MS, (1000 * i + ms) * MS
    return out


def _run(counters, trace=None, keyframes=3):
    run = harness.Run()
    run.counters = counters
    run.keyframe_ms = [90.0] * keyframes
    run.trace = trace
    return run


def test_readers_give_their_definitions(export):
    trace = TraceSummary(10.0, 20.0, {"map_update": 4.0}, {}, [])
    run = _run(export, trace)
    # Per keyframe: syncs under match and resolve 1+5, 2+6, 1+7.
    assert _read("frontend.sync_wait_ms", run) == 8.0
    # Match + resolve less their syncs: 4, 4, 6.
    assert _read("frontend.host_busy_ms", run) == 4.0
    assert _read("frontend.host_syncs_per_kf", run) == 9.0
    # Lock waits inside keyframes: 0 + 3 + 0 over 3; the backend's not.
    assert _read("frontend.lock_wait_ms", run) == 1.0
    assert _read("frontend.overflowed_match_share", run) == \
        pytest.approx(100.0 / 3)
    assert _read("map_builder.sync_wait_ms", run) == 2.0
    # Update less its syncs: 6, 6, 9.
    assert _read("map_builder.host_busy_ms", run) == 6.0
    assert _read("map_builder.host_syncs_per_kf", run) == 15.0
    assert _read("map_builder.raycast_roofline", run) == pytest.approx(
        100.0 * 6.7e9 / roofline.HBM_BYTES_PER_S / 4.0)
    assert _read("backend.detect_ms", run) == 30.0


def test_readers_read_nothing_without_their_inputs():
    """A program without spans or the new counters (the parent's export),
    and a trace without the map update's range."""
    bare = MetricManager().to_dict()
    bare["Counters"] = {"FrontendMxuMatches": {"type": "counter",
                                               "value": 3.0}}
    trace = TraceSummary(10.0, 20.0, {"frontend.match": 1.0}, {}, [])
    for name in NEW:
        assert _read(name, _run(bare, trace)) is None, name
    with_bytes = dict(bare, Counters={"MapBuilderRaycastBytes": {
        "type": "counter", "value": 1.0}})
    assert _read("map_builder.raycast_roofline",
                 _run(with_bytes, trace)) is None
    assert _read("map_builder.raycast_roofline",
                 _run(with_bytes, None)) is None
