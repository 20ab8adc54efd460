"""Host milliseconds in ``preprocess_frames`` a frame, over every request ingested in the window."""


def read(run):
    recs = [r for r in run.window.records if r.ingest_s is not None and r.error is None]
    frames = sum(r.n_frames for r in recs)
    return 1e3 * sum(r.preprocess_s for r in recs) / frames if frames else None
