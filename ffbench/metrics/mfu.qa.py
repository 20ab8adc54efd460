"""The whole request's share of the card's bf16 peak over the traced window.

FLOPs: the tower over every frame encoded there (exactly, from its shapes);
each admitted prefill at the configuration's ``cost`` times the dense
prompt's FLOPs (the budget FrameFusion is asked to meet, not the measured
compressed length, which the program does not expose); 2 x the decoder's
parameters a token read back. Over device-busy seconds x 989 TFLOP/s."""

from ffbench import flops


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_s()
    if not busy:
        return None
    text, cost = run.config["text"], run.config["framefusion"]["cost"]
    ops = sum(run.family.tower_work(run.config, r.n_frames)["flops"] for r in run.traced_ingests())
    ops += sum(cost * flops.dense_prefill_flops(text, a.prompt_len) for a in run.traced_admissions())
    ops += run.traced_tokens() * flops.decode_flops_per_token(text)
    return 100.0 * ops / flops.PEAK_BF16_FLOPS / busy
