"""The MLA decode-attention kernel's share of its roofline over the traced
batch: the least time of the latent rows each generated token needs (its
rows below its position, every layer, by the frozen
``families/mla_moe.py:mla_decode_cost``) over the device time of every
operation launched inside the benchmark's span around
``repro_torch.models.attention.mla_decode_attend``."""
from portbench import trace, yardstick

LAYER, UNIT, SOURCE = "kernels", "%", "device_trace"
MOVES = "tokens_per_s"
SPAN = ("repro_torch.models.attention", "mla_decode_attend")


def read(run):
    device_s = trace.device_seconds(run.trace, SPAN[1])
    cost = getattr(run.family, "mla_decode_cost", None)
    if device_s is None or cost is None:
        return None
    c = run.sizes
    esize = 2 if c.dtype == "bfloat16" else 4
    width = c.kv_lora_rank + c.qk_rope_head_dim
    least = 0.0
    for r in run.requests.values():
        if r.tokens is None or r.batch not in run.traced_batches:
            continue
        for j in range(1, r.max_new):       # token j attends P + j rows
            w = cost(1, c.num_attention_heads, width, c.kv_lora_rank,
                     r.prompt_len + j, esize)
            least += c.num_hidden_layers * yardstick.roofline_seconds(
                w["flops"], w["bytes"])
    return 100.0 * least / device_s
