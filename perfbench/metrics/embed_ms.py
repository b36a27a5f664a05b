"""Device ms a chunk of what the encoder and the classifier launched."""

from perfbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "pb.embed", "pb.classify")
