"""The decode-attention kernel's share of its roofline over the traced
batch: the least time of the K and V rows each generated token needs (its
rows below its position, every layer, by the frozen
``yardstick.decode_attention_cost``) over the device time of every
operation launched inside the benchmark's span around
``repro_torch.models.attention.decode_attend``."""
from portbench import trace, yardstick

LAYER, UNIT, SOURCE = "kernels", "%", "device_trace"
MOVES = "tokens_per_s"
SPAN = ("repro_torch.models.attention", "decode_attend")


def read(run):
    device_s = trace.device_seconds(run.trace, SPAN[1])
    if device_s is None:
        return None
    c = run.sizes
    esize = 2 if c.dtype == "bfloat16" else 4
    least = 0.0
    for r in run.requests.values():
        if r.tokens is None or r.batch not in run.traced_batches:
            continue
        for j in range(1, r.max_new):       # token j attends P + j rows
            cost = yardstick.decode_attention_cost(
                1, c.num_heads, c.num_kv_heads, c.head_dim,
                r.prompt_len + j, esize)
            least += c.num_layers * yardstick.roofline_seconds(
                cost["flops"], cost["bytes"])
    return 100.0 * least / device_s
