"""Host utilities: device selection, kernel build/launch bookkeeping and
frame construction."""
