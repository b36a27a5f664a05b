"""Fixed-shape batching and prefetch to the device.

Counterpart of ``vn_celeb_face_recognition_tpu/data/loader.py``, with its
semantics: ``np.random.default_rng(seed)`` shuffles, the last partial
batch is padded to the full batch size with copies of its first sample
and a per-row ``weight`` of 0 (1 for real rows), and each batch carries
its ``path`` list ('' for padding). Losses and metrics are
weight-averaged, so padding changes no result, and every batch has one
shape.

Under a data-parallel mesh (``set_block``) a process reads only its block
of each global batch: the rows ``index * bs / count`` up to the next
block's, in the one seeded order, padded as the global batch is. So the
blocks of all processes make up the one-process batch, and no process
decodes another's rows.

``prefetch_to_device`` moves the batches' arrays to the device in a
background thread, a few batches ahead of the consumer: on a card from
pinned host memory with ``non_blocking`` copies on a side stream, which
the consumer's stream waits for.
"""

import queue
import threading

import numpy as np
import torch


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 drop_last=False, num_workers=0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._block = (0, 1)
        # num_workers is accepted for config compatibility; reading runs
        # in prefetch_to_device's thread

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def rng_state(self):
        """The shuffle generator's state (for a checkpoint)."""
        return self._rng.bit_generator.state

    def set_rng_state(self, state):
        self._rng.bit_generator.state = state

    def set_block(self, index, count):
        """Yield block ``index`` of ``count`` equal blocks of each global
        batch (the batch size must split evenly)."""
        if self.batch_size % count:
            raise ValueError(f"batch size {self.batch_size} does not split "
                             f"into {count} data blocks")
        self._block = (int(index), int(count))

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        index, count = self._block
        rows = bs // count
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs][index * rows:(index + 1) * rows]
            samples = [self.dataset[int(i)] for i in idx]
            pad = rows - len(samples)
            if pad > 0:
                # padding copies the global batch's first sample (block 0
                # holds it; another block reads it once)
                first = (samples[0] if index == 0
                         else self.dataset[int(order[b * bs])])
                samples = samples + [first] * pad
            data = np.stack([s[0] for s in samples])
            real = len(samples) - pad
            target = np.asarray([s[1] for s in samples[:real]] + [0] * pad,
                                dtype=np.int32)
            weight = np.asarray([1.0] * real + [0.0] * pad,
                                dtype=np.float32)
            paths = [s[2] for s in samples[:real]] + [""] * pad
            yield {"data": data, "target": target, "weight": weight,
                   "path": paths}


def _to_device(item, device, stream):
    """The batch with its numpy arrays as tensors on ``device``, and the
    event that marks their copies (None off the card)."""
    out = dict(item)
    if stream is None:
        for k, v in item.items():
            if isinstance(v, np.ndarray):
                out[k] = torch.from_numpy(v).to(device)
        return out, None
    with torch.cuda.stream(stream):
        for k, v in item.items():
            if isinstance(v, np.ndarray):
                out[k] = torch.from_numpy(v).pin_memory().to(
                    device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def prefetch_to_device(iterator, device, size=2):
    """Yield the batches of ``iterator`` with their numpy arrays as
    tensors on ``device``, read and copied up to ``size`` batches ahead
    by a background thread, in order. An exception in the thread is
    raised to the consumer; closing the generator stops the thread."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(_to_device(item, device, stream)):
                    return
        except BaseException as exc:  # raised again in the consumer
            put((exc, None))
            return
        put((end, None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item, done = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for v in item.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
