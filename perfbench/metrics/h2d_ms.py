"""Device ms a chunk of host-to-device copies: the chunk's upload."""

from perfbench.readers import h2d_ms as read  # noqa: F401
