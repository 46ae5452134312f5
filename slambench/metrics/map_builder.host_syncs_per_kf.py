"""map_builder.host_syncs_per_kf: the program's ``HostSyncs.map_builder``
counter (uploads under its map builder spans, the backend's rebuilds
included, ``utils/device.py``) over the window's keyframes."""


def read(run):
    c = run.counters.get("Counters", {}).get("HostSyncs.map_builder")
    if c is None or not run.keyframes:
        return None
    return c["value"] / run.keyframes
