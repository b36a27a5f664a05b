"""Device ms a chunk of what the detector's ``detect_padded`` launched."""

from perfbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "pb.detect")
