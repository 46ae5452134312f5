"""map_builder.raycast_roofline: the least time the card could take for
the map builder's casts in the traced window, the program's
``MapBuilderRaycastBytes`` (the bytes the casts must move by their
definition: 9 per cell a valid beam visits, 5 per cell of each map made
or cleared) over ``roofline.HBM_BYTES_PER_S``, over the device time of
the ``map_update`` ranges, in percent. It reads the same work whatever
implements the cast."""

from slambench import roofline


def read(run):
    c = run.counters.get("Counters", {}).get("MapBuilderRaycastBytes")
    if c is None or run.trace is None:
        return None
    device_s = run.trace.device_s.get("map_update")
    if not device_s:
        return None
    return 100.0 * c["value"] / roofline.HBM_BYTES_PER_S / device_s
