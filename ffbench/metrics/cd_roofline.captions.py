"""Kernels C and D's share of their roofline in decode: every replayed macro
step reads the decoder's int8 weights and scales once, at 3.35 TB/s, over
the device time of C and D's kernels in the replays of the traced window."""

from ffbench import flops

KERNELS = ("gemv_kernel", "rows_kernel", "gateup_reduce_kernel")


def read(run):
    if run.trace is None or not run.trace.graph_launches:
        return None
    seconds = run.trace.device_seconds(lambda o: o.graph and any(k in o.name for k in KERNELS))
    if not seconds:
        return None
    nbytes = run.trace.graph_launches * flops.cd_bytes_per_step(run.config["text"])
    return 100.0 * nbytes / flops.PEAK_BYTES_PER_S / seconds
