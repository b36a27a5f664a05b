"""100 x the valid faces ``identify`` named over the per-face slots the
engine ran through align, embed and the heads (the program's counters
``engine.faces`` and ``engine.slots``, over the traced chunks: the harness
clears the program's one counter store with its launch counts at the
traced step 1). None where the program keeps no such counters."""


def read(ctx):
    from vn_celeb_face_recognition_tpu_torch.utils import tracing

    if not hasattr(tracing, "counts"):
        return None
    c = tracing.counts()
    if not c.get("engine.slots"):
        return None
    return 100.0 * c.get("engine.faces", 0) / c["engine.slots"]
