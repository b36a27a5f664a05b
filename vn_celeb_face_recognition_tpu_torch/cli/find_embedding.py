"""Dataset embedding extraction CLI on the port.

Counterpart of the repo-root ``find_embedding.py``, with its flags: embed
every image of a directory (aligned faces) with the chosen encoder and
write one compressed ``<stem>.npz`` per image into the output directory.

  python -m vn_celeb_face_recognition_tpu_torch.cli.find_embedding \\
      -d train -o train_embedding -bz 64 -w none

Images are decoded (``utils.frames.read_image``) by a thread pool that
returns them in file order, a few batches ahead of the card, so each
``.npz`` holds its own file's embedding. Every batch has ``-bz`` images
(the tail batch is padded with its first image). The first image's size
sets the batch shape, and images of other sizes are resized to it with
PIL's bilinear filter (``utils.frames.resize_bilinear``); with
``--image_size N`` every image is resized to N x N as the JAX package's
native loader resizes (``utils.frames.resize_bilinear_half_pixel``).
``-w none`` gives the seeded initialisation; a named weight set must be a
local file (nothing downloads).
"""

import argparse
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..data.transforms import transforms_dict
from ..models import local_weights
from ..pipeline import Encoder
from ..utils.device import select_device
from ..utils.frames import (
    read_image,
    resize_bilinear,
    resize_bilinear_half_pixel,
)


def iter_image_batches(data_dir, list_files, batch_size, size=None,
                       threads=None, prefetch=2):
    """Yield (uint8 [batch_size, H, W, 3], the batch's file names) in file
    order. Images decode on ``threads`` workers, up to ``prefetch`` batches
    ahead of the consumer; ``size`` as the module docstring says."""
    paths = [str(Path(data_dir) / f) for f in list_files]
    if not paths:
        return
    if size:
        target, resize = (size, size), resize_bilinear_half_pixel
    else:
        first = read_image(paths[0])
        target, resize = (first.shape[1], first.shape[0]), resize_bilinear

    def load(path):
        img = read_image(path)
        if (img.shape[1], img.shape[0]) != target:
            img = resize(img, target)
        return img

    def collect(start, results):
        batch = list(results)  # in submission order: file order
        names = list_files[start:start + len(batch)]
        while len(batch) < batch_size:  # pad the tail batch
            batch.append(batch[0])
        return np.stack(batch), names

    with ThreadPoolExecutor(threads or os.cpu_count() or 4) as pool:
        pending = deque()
        for start in range(0, len(paths), batch_size):
            pending.append((start, pool.map(
                load, paths[start:start + batch_size])))
            if len(pending) > prefetch:
                yield collect(*pending.popleft())
        while pending:
            yield collect(*pending.popleft())


def save_embeddings(embeddings, list_files, output_dir):
    output_dir_path = Path(output_dir)
    for i, fname in enumerate(list_files):
        emb_name = "{}.npz".format(fname.split(".")[0])
        np.savez_compressed(str(output_dir_path / emb_name), embeddings[i])


def cal_embedding(data_dir, batch_size, model, output_dir, log=True,
                  image_size=None, threads=None):
    """Embed every file of ``data_dir`` (sorted by name) into
    ``output_dir``; returns the number of embeddings written."""
    if not os.path.exists(output_dir):
        os.makedirs(output_dir)
    list_files = sorted(os.listdir(data_dir))
    n_batches = -(-len(list_files) // batch_size)
    done = 0
    for idx, (batch, names) in enumerate(iter_image_batches(
            data_dir, list_files, batch_size, size=image_size,
            threads=threads)):
        embeddings = model(batch.astype(np.float32))
        save_embeddings(embeddings[: len(names)], names, output_dir)
        done += len(names)
        if log:
            print("Processing for {}/{} batchs:".format(idx, n_batches))
    if log:
        print("Saved {} embeddings to {}".format(done, output_dir))
    return done


def build_encoder(name, pre_trained, device):
    """The encoder of ``-enc``/``-w`` on ``device``, with the default
    (fix_std) transform. ``pre_trained`` '' or 'none' gives the seeded
    initialisation; a named set raises unless its local file exists."""
    if isinstance(pre_trained, str) and pre_trained.lower() in ("", "none"):
        pre_trained = None
    if name == "InceptionResnetV1":
        pretrained = pre_trained
    else:
        pretrained = bool(pre_trained)
    if pretrained and local_weights(name, pretrained) is None:
        raise FileNotFoundError(
            f"-w {pre_trained}: no local weights of {name} (nothing is "
            "downloaded; convert the published checkpoint with "
            "tools/convert_weights.py, or pass -w none for the seeded "
            "initialisation)")
    model = Encoder.build(name, device=device, pretrained=pretrained)
    model.transform = transforms_dict["default"]
    return model


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Find embedding vectors for all images in a dataset"
    )
    parser.add_argument("-d", "--data_dir", default="train")
    parser.add_argument("-bz", "--batch_size", default=64, type=int)
    parser.add_argument("-o", "--output_dir", default="train_embedding")
    parser.add_argument("-w", "--pre_trained", default="vggface2")
    parser.add_argument("-dv", "--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("-enc", "--encoder", default="InceptionResnetV1")
    parser.add_argument("--image_size", default=None, type=int,
                        help="resize every image to this square size")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    select_device(args.device)
    model = build_encoder(args.encoder, args.pre_trained, args.device)
    return cal_embedding(args.data_dir, args.batch_size, model,
                         args.output_dir, image_size=args.image_size)


if __name__ == "__main__":
    main()
