"""greedy_cost_roofline: K2 (``csrc/greedy_cost.cu``), the sum over the
traced window's calls of the least time the card could take for each
(``roofline.py``) over the device time of K2's kernels, in percent."""

from slambench import roofline


def read(run):
    calls = run.kernel_calls.get("greedy_cost")
    device_s = run.trace.kernel_seconds("greedy_cost_kernel")
    if not calls or not calls.calls or device_s <= 0:
        return None
    bound = sum(roofline.greedy_cost_bound_s(a, k) for a, k in calls.calls)
    return 100.0 * bound / device_s
