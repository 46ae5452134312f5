"""frontend.host_syncs_per_kf: the program's ``HostSyncs.frontend``
counter (uploads, host reads and event waits under its frontend spans,
``utils/device.py``) over the window's keyframes."""


def read(run):
    c = run.counters.get("Counters", {}).get("HostSyncs.frontend")
    if c is None or not run.keyframes:
        return None
    return c["value"] / run.keyframes
