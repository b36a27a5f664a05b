"""``slot_use_pct`` in the cells whose card waits on the host, where it
moves ``frames_per_s.host_bound``."""

from perfbench.harness import metric_reader

read = metric_reader("slot_use_pct")
