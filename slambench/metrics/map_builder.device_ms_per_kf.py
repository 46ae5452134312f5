"""map_builder.device_ms_per_kf: device milliseconds of the kernels
launched inside ``map_update`` ranges (``update_grid_map`` and the
backend's ``after_loop_closure``), per keyframe of the traced window."""


def read(run):
    s = run.trace.device_s.get("map_update")
    if not s or not run.keyframes:
        return None
    return 1e3 * s / run.keyframes
