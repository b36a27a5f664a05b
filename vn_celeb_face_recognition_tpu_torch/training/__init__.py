"""Training-side utilities; so far the checkpoint reader."""
