"""Data transforms (the inference half of the JAX package's ``data/``)."""
