"""Share of the traced window in which no kernel ran (copies count as
idle; ``h2d_ms`` shows them)."""

from perfbench.readers import idle_pct as read  # noqa: F401
