"""Misc host helpers (counterpart of the JAX package's ``utils/misc.py``,
the part the CLIs use)."""


def convert_sec_to_max_time_quantity(second):
    """Seconds -> ``"{h}h:{m}m:{s:.2f}s"``, the time format of
    ``tracker.json``."""
    h = second // 3600
    remain_time = second % 3600
    m = remain_time // 60
    s = remain_time % 60
    return "{}h:{}m:{:.2f}s".format(h, m, s)
