"""Loss and metric registry.

Counterpart of ``vn_celeb_face_recognition_tpu/training/losses.py``: the
models output log-probabilities, the loss is their weighted negative
log-likelihood and the metric a weighted argmax accuracy. ``weights``
carries the padding mask of the fixed-shape ``DataLoader`` (1 for a real
row, 0 for padding), so padded rows contribute nothing.
"""

import torch


def _weighted_mean(values, weights):
    if weights is None:
        return values.mean()
    weights = weights.to(values.dtype)
    return (values * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def neg_log_llhood(log_probs, targets, weights=None):
    """Mean negative log-likelihood of the target class."""
    picked = log_probs.gather(1, targets.to(torch.int64)[:, None])[:, 0]
    return -_weighted_mean(picked, weights)


def accuracy(log_probs, targets, weights=None):
    """Fraction of argmax matches."""
    match = (log_probs.argmax(dim=1) == targets.to(torch.int64))
    return _weighted_mean(match.to(log_probs.dtype), weights)


LOSSES = {"neg_log_llhood": neg_log_llhood}
METRICS = {"accuracy": accuracy}
