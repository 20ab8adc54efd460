"""Milliseconds between CUDA events around ``build_inputs`` (tower, projector, prompt) a frame."""


def read(run):
    recs = [r for r in run.window.records if r.encode_events is not None]
    frames = sum(r.n_frames for r in recs)
    if not frames:
        return None
    return sum(a.elapsed_time(b) for a, b in (r.encode_events for r in recs)) / frames
