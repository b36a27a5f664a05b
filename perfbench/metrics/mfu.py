"""The window's model FLOPs over its seconds, as a share of the card's
495 TFLOP/s TF32 peak (the tensor-core format these configurations let
the card use); see ``readers.mfu_pct``."""

from perfbench.readers import mfu_pct as read  # noqa: F401
