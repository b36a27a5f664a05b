"""Training CLI on the port.

Counterpart of the repo-root ``train.py``, with its flags and config
schema:

  python -m vn_celeb_face_recognition_tpu_torch.cli.train \\
      -c cfg/train_cfg_emb_classify.json [-d CPU]

Training runs on the card unless ``-d CPU`` is given; without a card it
raises. A config's ``"device": "TPU"`` (or ``"GPU"``, ``"cuda"``) names the
accelerator, here the card; ``"CPU"`` the CPU; ``-d`` overrides it.
Model weights that the config asks for load from local files as
``models.build_model`` finds them; without them the weights are seeded.

With ``trainer.n_devices`` > 1 the run is data parallel: ``parallel.launch``
starts that many processes (NCCL on cards, one card each; gloo processes
with ``-d CPU``), each builds the trainer, which joins them in a data mesh,
and rank 0 logs and writes the checkpoints. ``main`` then returns rank 0's
``{"save_dir": ..., "log_dir": ...}``.
"""

import argparse

from .. import models as model_md
from .. import registry
from ..data import DataLoader
from ..parallel import launch
from ..utils.device import select_device
from ..utils.io import read_json

SEED = 123


def config_device(name):
    """A ``-d`` flag or a config's ``trainer.device`` -> ``torch.device``:
    None or TPU is the card (raises without one), as ``select_device``
    takes GPU and cuda; CPU the CPU."""
    key = "cuda" if name is None else str(name).strip().lower()
    return select_device("cuda" if key == "tpu" else key)


def build_trainer_from_config(config, seed=SEED, device="cuda"):
    """(trainer, train_loader, val_loader) from a config dict, as the
    repo-root ``train.py`` builds them."""
    device = select_device(device)
    train_ds = registry.build_dataset(config["train_dataset"]["name"],
                                      **config["train_dataset"]["args"])
    val_ds = registry.build_dataset(config["val_dataset"]["name"],
                                    **config["val_dataset"]["args"])
    train_loader = DataLoader(train_ds, seed=seed,
                              **config["train_data_loader"]["args"])
    val_loader = DataLoader(val_ds, **config["val_data_loader"]["args"])
    model = model_md.build_model(config["model"]["name"],
                                 **config["model"]["args"])
    trainer = registry.build_trainer(config["trainer"]["name"], config,
                                     model, seed=seed, device=device)
    trainer.setup_loader(train_loader, val_loader)
    return trainer, train_loader, val_loader


def build_arg_parser(description="VNCeleb - Face Recognition (PyTorch)"):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="Path of config file")
    parser.add_argument("-d", "--device", default=None, type=str,
                        help="CPU runs on the CPU; default (or the "
                             "config's TPU/GPU) uses the card")
    return parser


def parse(argv=None):
    """(config, device) from the command line."""
    args = build_arg_parser().parse_args(argv)
    config = read_json(args.config)
    return config, config_device(args.device
                                 or config["trainer"].get("device"))


def train_rank(config, device):
    """One process of a data-parallel run: build, train; the run's
    directories."""
    trainer, _, _ = build_trainer_from_config(config, device=device)
    trainer.train(config["trainer"]["track4plot"])
    return {"save_dir": str(trainer.save_dir),
            "log_dir": str(trainer.log_dir)}


def main(argv=None):
    config, device = parse(argv)
    n_devices = int(config["trainer"].get("n_devices", 1))
    if n_devices > 1:
        return launch(train_rank, n_devices, device.type, config,
                      device.type)
    trainer, _, _ = build_trainer_from_config(config, device=device)
    trainer.train(config["trainer"]["track4plot"])
    return trainer


if __name__ == "__main__":
    main()
