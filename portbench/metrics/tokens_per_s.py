"""Output tokens that landed inside the window over the window's seconds
(the window: the first submission to the return of the last batch
submitted)."""
from portbench import harness

LAYER, UNIT, SOURCE = "end to end", "tokens/s", "host_clock"


def read(run):
    return harness.tokens_in_window(run) / run.window_s
