"""The model's operations in the window, as a share of the chip's bf16
dense peak over the window's seconds: each request's prompt
through every layer and the LM head at its last position, then one decode
step a further token, counted by the family's own formula
(``families/<family>.py:request_flops``)."""
from portbench import yardstick

LAYER, UNIT, SOURCE = "model step", "%", "host_clock"
MOVES = "tokens_per_s"


def read(run):
    flops = sum(run.family.request_flops(run.sizes, r.prompt_len, r.max_new)
                for r in run.requests.values() if r.tokens is not None)
    if not flops or run.window_s <= 0:
        return None
    return 100.0 * flops / (run.window_s * yardstick.PEAKS["bf16_flops"])
