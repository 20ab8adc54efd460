"""The decode window's share of the card's memory bandwidth: every replayed
macro step reads the decoder's weights once (int8 layers with their scales,
norms, the bf16 head), at 3.35 TB/s, over device-busy seconds."""

from ffbench import flops


def read(run):
    if run.trace is None or not run.trace.graph_launches:
        return None
    busy = run.trace.busy_s()
    nbytes = run.trace.graph_launches * flops.decode_weight_bytes(run.config["text"])
    return 100.0 * nbytes / flops.PEAK_BYTES_PER_S / busy if busy else None
