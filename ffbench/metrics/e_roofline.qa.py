"""Kernel E's share of its roofline: the tower's attention operations
(4 B H N^2 hd a launch, from the tower's shapes) of the requests encoded in
the traced window, at 989 TFLOP/s, over E's device time there."""

from ffbench import flops

KERNEL = "bidir_attn"


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_seconds(lambda o: KERNEL in o.name)
    launches = [sh for r in run.traced_ingests() for sh in run.family.tower_work(run.config, r.n_frames)["e_launches"]]
    if not seconds or not launches:
        return None
    return 100.0 * sum(flops.e_flops(*sh) for sh in launches) / flops.PEAK_BF16_FLOPS / seconds
