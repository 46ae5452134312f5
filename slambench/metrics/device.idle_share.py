"""device.idle_share: the share of the traced window in which no kernel,
copy or fill ran on the card (one minus the union of the busy intervals
over the window), in percent."""


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
