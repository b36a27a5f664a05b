"""Running-average metric tracking.

Counterpart of ``vn_celeb_face_recognition_tpu/utils/metrics.py``: keyed
running averages with ``update(key, value, n)`` / ``avg(key)`` /
``result()``, on plain dicts.
"""


class MetricTracker:
    def __init__(self, *keys, writer=None):
        self.writer = writer
        self._keys = list(keys)
        self._total = {}
        self._counts = {}
        self.reset()

    def reset(self):
        for key in self._keys:
            self._total[key] = 0.0
            self._counts[key] = 0

    def update(self, key, value, n=1):
        if self.writer is not None:
            self.writer.add_scalar(key, value)
        if key not in self._total:
            self._keys.append(key)
            self._total[key] = 0.0
            self._counts[key] = 0
        self._total[key] += float(value) * n
        self._counts[key] += n

    def avg(self, key):
        if self._counts.get(key, 0) == 0:
            return 0.0
        return self._total[key] / self._counts[key]

    def result(self):
        return {key: self.avg(key) for key in self._keys}
