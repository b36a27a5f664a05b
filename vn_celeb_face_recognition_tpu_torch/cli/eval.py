"""Evaluation CLI on the port.

Counterpart of the repo-root ``eval.py``: the wiring of ``cli.train``,
then ``trainer.eval(save_result)``, which writes ``result.csv`` (Path,
Target, Prediction, Probability) when the config's
``trainer.save_result`` is true. ``trainer.resume_path`` names the
checkpoint to evaluate (of the port or of the JAX package). With
``trainer.n_devices`` > 1 it runs data parallel under ``parallel.launch``,
as ``cli.train`` does, and returns rank 0's ``{"save_dir": ..., "log":
...}``.

  python -m vn_celeb_face_recognition_tpu_torch.cli.eval -c <config> [-d CPU]
"""

from ..parallel import launch
from .train import build_trainer_from_config, parse


def eval_rank(config, device):
    """One process of a data-parallel evaluation."""
    trainer, _, _ = build_trainer_from_config(config, device=device)
    log = trainer.eval(config["trainer"]["save_result"])
    return {"save_dir": str(trainer.save_dir), "log": log}


def main(argv=None):
    config, device = parse(argv)
    n_devices = int(config["trainer"].get("n_devices", 1))
    if n_devices > 1:
        return launch(eval_rank, n_devices, device.type, config, device.type)
    trainer, _, _ = build_trainer_from_config(config, device=device)
    trainer.eval(config["trainer"]["save_result"])
    return trainer


if __name__ == "__main__":
    main()
