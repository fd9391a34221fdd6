"""The traced window's share in which no operation ran on the device: one
less the union of the device operations' intervals over the window (the
first submission to the first batch's return)."""
LAYER, UNIT, SOURCE = "device", "%", "device_trace"
MOVES = "tokens_per_s"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
