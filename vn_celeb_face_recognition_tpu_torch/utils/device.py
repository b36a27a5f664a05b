"""Device selection (counterpart of ``utils/platform.select_platform``).

The CLIs name a device as ``cpu`` or ``cuda``. Asking for ``cuda`` on a
machine without a visible card raises: a run that was meant for the card
must never silently measure or validate the CPU.
"""

import torch


def select_device(name):
    """``"cpu"`` | ``"cuda"`` | ``"cuda:N"`` (case-insensitive) ->
    ``torch.device``. Raises ``RuntimeError`` for a CUDA device that is
    not available and ``ValueError`` for any other name."""
    key = str(name).strip().lower()
    if key == "cpu":
        return torch.device("cpu")
    if key == "gpu":
        key = "cuda"
    if key == "cuda" or key.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch sees no CUDA device "
                f"(torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda})")
        dev = torch.device(key)
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        return dev
    raise ValueError(f"unknown device {name!r}; expected 'cpu' or 'cuda'")
