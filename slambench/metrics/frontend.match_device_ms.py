"""frontend.match_device_ms: device milliseconds of the kernels launched
inside ``frontend.match`` ranges, per keyframe of the traced window."""


def read(run):
    s = run.trace.device_s.get("frontend.match")
    if not s or not run.keyframes:
        return None
    return 1e3 * s / run.keyframes
