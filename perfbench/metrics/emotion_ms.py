"""Device ms a chunk of what the emotion net launched (K7, cuDNN, K8)."""

from perfbench.readers import span_ms


def read(ctx):
    if "emotion" not in ctx.calls:
        return None
    return span_ms(ctx, "pb.emotion")
