"""Evaluation CLI on the port.

Counterpart of the repo-root ``eval.py``: the wiring of ``cli.train``,
then ``trainer.eval(save_result)``, which writes ``result.csv`` (Path,
Target, Prediction, Probability) when the config's
``trainer.save_result`` is true. ``trainer.resume_path`` names the
checkpoint to evaluate (of the port or of the JAX package).

  python -m vn_celeb_face_recognition_tpu_torch.cli.eval -c <config> [-d CPU]
"""

from .train import build_trainer_from_config, parse


def main(argv=None):
    config, device = parse(argv)
    trainer, _, _ = build_trainer_from_config(config, device=device)
    trainer.eval(config["trainer"]["save_result"])
    return trainer


if __name__ == "__main__":
    main()
