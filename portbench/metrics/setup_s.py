"""Process start to the first timed submission: imports and CUDA's start,
the weights made on the device from the seed, the runtime built, the
kernels' library loaded (built by the first run in a checkout), one warm
request through each group."""
LAYER, UNIT, SOURCE = "end to end", "s", "host_clock"


def read(run):
    return run.setup_s
