"""Config-driven training runtime (counterpart of the JAX package's
``training/trainer.py``).

The same behaviour as the JAX trainers:
  * run dirs ``save_dir/{models,logs}/<run_id>``, the run logged to the
    console and ``info.txt``;
  * ``MetricTracker`` epoch logs (the loss averaged over batches, the
    metrics over real samples), a step log every ``log_step`` batches;
  * best-metric monitoring (min/max), early stop after ``patience``
    epochs without improvement, ``checkpoint-epoch{N}.ckpt`` every
    ``save_period`` epochs and ``model_best.ckpt`` on an improvement;
  * ``track4plot``: ``log_loss.txt`` (Epoch,Train_loss,Validation_loss)
    in the log dir;
  * ReduceLROnPlateau stepped on the validation loss each epoch;
  * ``eval(save_result=True)`` writing ``result.csv`` (Path, Target,
    Prediction, Probability);
  * ``AugClassificationTrainer``: a frozen encoder, chosen by
    ``chosen_idx_enc``, between the augmentation and the MLP;
  * a model with BatchNorm (``cfg/train_cfg_img_classify.json``'s
    InceptionResnetV1 with its classify head) trains in train mode: its
    BatchNorms normalise with the batch's statistics, the loader's padded
    rows included as in the JAX trainer, and update their running ones
    once a step (flax's ``batch_stats``); validation runs in eval mode on
    the running statistics.

In PyTorch's idiom: the model is an ``nn.Module`` on an explicit device,
built with its weights before the trainer (never lazily from the first
batch); the step is forward, loss, ``backward`` and torch's optimizer;
one ``torch.Generator`` on the device draws the augmentation and the
dropout masks. Image batches (NHWC, as the loader and the transforms
give them) reach the model or the frozen encoder as NCHW. MultiStepLR
has torch's semantics (the JAX trainer compounds it; ROADMAP.md C7), and
it steps before the epoch's checkpoint is written, so that a resumed run
continues exactly. Batches reach the device through
``data.prefetch_to_device``.

Only one device: a mesh or ``n_devices`` > 1 raises (ROADMAP.md A.8).
"""

import logging
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..data.loader import prefetch_to_device
from ..data.transforms import get_transform, with_resize
from ..utils.device import select_device
from ..utils.io import append_log_to_file, create_folder, save_csv
from ..utils.logging import setup_logging
from ..utils.metrics import MetricTracker
from ..utils.tracing import annotate
from .checkpoint import (
    load_checkpoint,
    load_state_dict_from_jax,
    restore_optimizer,
    save_checkpoint,
    trainer_state_from,
)
from .losses import LOSSES, METRICS
from .optim import make_lr_scheduler, make_optimizer

_MultiStepLR = torch.optim.lr_scheduler.MultiStepLR
_ReduceLROnPlateau = torch.optim.lr_scheduler.ReduceLROnPlateau


class BaseTrainer:
    def __init__(self, config, model, loss=None, metrics=None,
                 optimizer=None, lr_scheduler=None, mesh=None, seed=123,
                 device="cuda"):
        tcfg = config["trainer"]
        if mesh is not None or tcfg.get("n_devices", 1) > 1:
            raise NotImplementedError(
                "data-parallel training (a mesh, n_devices > 1) is not "
                "ported yet (ROADMAP.md A.8)")
        self.config = config
        self.device = select_device(device)
        self.model = model.to(self.device)
        self.loss_name = config["loss"]
        self.loss_fn = loss if loss is not None else LOSSES[self.loss_name]
        if metrics is not None:
            self.metric_fns = {m.__name__: m for m in metrics}
        else:
            self.metric_fns = {m: METRICS[m]
                               for m in config.get("metrics", [])}
        self.metric_names = list(self.metric_fns)

        self.optimizer = optimizer if optimizer is not None else \
            make_optimizer(config["optimizer"]["name"],
                           config["optimizer"]["args"],
                           self.model.parameters())
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
        elif "lr_scheduler" in config:
            self.lr_scheduler = make_lr_scheduler(
                config["lr_scheduler"]["name"],
                config["lr_scheduler"]["args"], self.optimizer)
        else:
            self.lr_scheduler = None

        self.start_epoch = 1
        self.epochs = tcfg["epochs"]
        self.tracked_metric, self.mode_monitor = tcfg["tracked_metric"]
        self.early_stop = tcfg["patience"]
        self.save_step = tcfg["save_period"]
        self.log_step = tcfg["log_step"]
        self.do_val = tcfg["do_validation"]
        self.val_step = tcfg["validation_step"]

        self.train_loss = MetricTracker(self.loss_name)
        self.train_metrics = MetricTracker(*self.metric_names)
        self.val_loss = MetricTracker(self.loss_name)
        self.val_metrics = MetricTracker(*self.metric_names)

        save_dir = Path(tcfg["save_dir"])
        run_id = datetime.now().strftime(r"%m%d_%H%M%S")
        self.save_dir = save_dir / "models" / run_id
        self.log_dir = save_dir / "logs" / run_id
        create_folder(self.save_dir)
        create_folder(self.log_dir)
        setup_logging(self.log_dir)
        self.logger = logging.getLogger("trainer")

        self.mnt_best = np.inf if self.mode_monitor == "min" else -np.inf
        self.not_improve_count = 0
        self.train_transform, self.val_transform = self._build_transforms()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.train_loader = None
        self.val_loader = None
        self._loader_state = None
        cp_path = tcfg.get("resume_path", "")
        if cp_path:
            self.resume_checkpoint(cp_path)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _build_transforms(self):
        tf_config = self.config.get("transforms", "none")
        if not isinstance(tf_config, dict):
            return None, None
        train_tf = get_transform(tf_config.get("name", "none"))
        val_tf = get_transform("default")
        if tf_config.get("resize"):
            size = tf_config["encoder_img_size"]
            if train_tf is not None:
                train_tf = with_resize(train_tf, size)
            val_tf = with_resize(val_tf, size)
        return train_tf, val_tf

    def setup_loader(self, train_loader, val_loader):
        self.train_loader = train_loader
        self.val_loader = val_loader
        if self._loader_state is not None:
            train_loader.set_rng_state(self._loader_state)
            self._loader_state = None

    def _prepare_input(self, data, train):
        """The batch's data through the train or validation transform; an
        image batch comes out NCHW, the modules' layout."""
        tf = self.train_transform if train else self.val_transform
        if tf is not None:
            with annotate("augment" if train else "transform", self.device):
                data = tf(data, self.generator)
        return data.permute(0, 3, 1, 2) if data.dim() == 4 else data

    def _encode(self, x):
        """Hook for trainers that run a frozen encoder before the model."""
        return x

    def _batches(self, loader):
        return prefetch_to_device(iter(loader), self.device)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _metrics(self, out, target, weight):
        return [fn(out, target, weight) for fn in self.metric_fns.values()]

    def _train_step(self, batch):
        """One optimisation step on a device batch. Returns [loss, sum of
        the weights, *metrics] as Python floats (one copy to the host)."""
        x = self._encode(self._prepare_input(batch["data"], train=True))
        return self._update(x, batch["target"], batch["weight"])

    def _update(self, x, target, weight):
        """Forward, loss, backward and the optimizer's step on the model's
        input ``x``; the step's values as ``_train_step`` returns them."""
        loss, out = self._forward_backward(x, target, weight)
        self._optimizer_step()
        with torch.no_grad():
            vals = torch.stack([loss.detach(), weight.sum(),
                                *self._metrics(out, target, weight)])
        return vals.tolist()

    def _forward_backward(self, x, target, weight):
        """The model in train mode on ``x`` (its BatchNorms update their
        running statistics), the loss and its gradients. Returns (loss,
        model output)."""
        with annotate("forward_backward", self.device):
            self.model.train()
            out = self.model(x, generator=self.generator)
            loss = self.loss_fn(out, target, weight)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            return loss, out.detach()

    def _optimizer_step(self):
        with annotate("optimizer", self.device):
            self.optimizer.step()

    @torch.no_grad()
    def _eval_step(self, batch):
        """Loss, weight sum and metrics (floats), and the predictions and
        their probabilities (device tensors) of a device batch."""
        self.model.eval()
        x = self._encode(self._prepare_input(batch["data"], train=False))
        target, weight = batch["target"], batch["weight"]
        out = self.model(x)
        loss = self.loss_fn(out, target, weight)
        pred = out.argmax(dim=1)
        prob = out.gather(1, pred[:, None])[:, 0].exp()
        vals = torch.stack([loss, weight.sum(),
                            *self._metrics(out, target, weight)]).tolist()
        return vals, pred, prob

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def trainer_state(self):
        """What a checkpoint needs beyond the JAX package's fields for a
        resumed run to continue exactly."""
        return {
            "lr_scheduler": (None if self.lr_scheduler is None
                             else self.lr_scheduler.state_dict()),
            "generator": self.generator.get_state(),
            "loader_rng": (None if self.train_loader is None
                           else self.train_loader.rng_state()),
            "not_improve_count": self.not_improve_count,
        }

    def resume_checkpoint(self, checkpoint_path):
        """Resume from a checkpoint of the port (everything restored) or
        of the JAX package (weights, epoch, best metric, learning rate and
        the optimizer's moments; a fresh scheduler, as the JAX trainer
        has after a resume)."""
        cp = load_checkpoint(checkpoint_path)
        self.logger.info("Loading checkpoint: {} ...".format(checkpoint_path))
        self.start_epoch = cp["epoch"] + 1
        self.mnt_best = cp["monitor_best"]
        load_state_dict_from_jax(self.model, cp["state_dict"])
        restore_optimizer(self.optimizer, self.model, cp["optimizer"],
                          cp["state_dict"].get("batch_stats"))
        state = trainer_state_from(cp)
        if state is not None:
            if self.lr_scheduler is not None:
                self.lr_scheduler.load_state_dict(state["lr_scheduler"])
            self.generator.set_state(state["generator"])
            self._loader_state = state["loader_rng"]
            self.not_improve_count = state["not_improve_count"]
        elif isinstance(self.lr_scheduler, _MultiStepLR):
            self.lr_scheduler.last_epoch = cp["epoch"]
        self.logger.info(
            "Checkpoint loaded. Resume training from epoch {}".format(
                self.start_epoch))

    def _save(self, path, epoch):
        save_checkpoint(path, arch=type(self.model).__name__, epoch=epoch,
                        model=self.model, optimizer=self.optimizer,
                        monitor_best=self.mnt_best, config=self.config,
                        trainer_state=self.trainer_state())

    def save_checkpoint_file(self, epoch, save_best):
        filename = str(self.save_dir / f"checkpoint-epoch{epoch}.ckpt")
        self._save(filename, epoch)
        self.logger.info("Saving checkpoint: {} ...".format(filename))
        if save_best:
            self._save(str(self.save_dir / "model_best.ckpt"), epoch)
            self.logger.info("Saving current best: model_best.ckpt ...")

    def reset_metrics_tracker(self):
        for tracker in (self.train_loss, self.train_metrics, self.val_loss,
                        self.val_metrics):
            tracker.reset()

    # ------------------------------------------------------------------
    # main loops
    # ------------------------------------------------------------------

    def train(self, track4plot=False):
        if track4plot:
            self.track4plot = str(self.log_dir / "log_loss.txt")
            append_log_to_file(
                self.track4plot, ["Epoch", "Train_loss", "Validation_loss"])

        for epoch in range(self.start_epoch, self.epochs + 1):
            result = self._train_epoch(epoch)
            if track4plot:
                lines = [epoch, result.get(self.loss_name),
                         result.get("val_" + self.loss_name)]
                append_log_to_file(self.track4plot, [str(x) for x in lines])

            log = {"epoch": epoch}
            log.update(result)
            for key, value in log.items():
                self.logger.info("    {:15s}: {}".format(str(key), value))

            best = False
            tracked_metric = log.get(self.tracked_metric)
            if tracked_metric is not None:
                improved = (
                    (self.mode_monitor == "min"
                     and tracked_metric < self.mnt_best)
                    or (self.mode_monitor == "max"
                        and tracked_metric > self.mnt_best))
                if improved:
                    self.mnt_best = tracked_metric
                    self.not_improve_count = 0
                    best = True
                else:
                    self.not_improve_count += 1

            if self.not_improve_count > self.early_stop:
                self.logger.info(
                    "Validation performance didn't improve for {} epochs. "
                    "Training stops.".format(self.early_stop))
                break

            if isinstance(self.lr_scheduler, _MultiStepLR):
                self.lr_scheduler.step()
            if epoch % self.save_step == 0:
                self.save_checkpoint_file(epoch, save_best=best)

    def eval(self, save_result=False):
        if save_result:
            log, result = self._validate_epoch(1, save_result=True)
            res_path = str(self.save_dir / "result.csv")
            rows = [row for batch_rows in result
                    for row in zip(*batch_rows)]
            save_csv(rows, res_path,
                     columns=["Path", "Target", "Prediction", "Probability"])
            print("Saved prediction to {}.".format(res_path))
        else:
            log = self._validate_epoch(1)
        for key, value in log.items():
            self.logger.info("    {:15s}: {}".format(str(key), value))
        return log

    def _train_epoch(self, epoch):
        raise NotImplementedError

    def _validate_epoch(self, epoch, save_result=False):
        raise NotImplementedError


class ClassificationTrainer(BaseTrainer):
    """Forward / NLL / backward / step loop on the device (the JAX
    package's ``ClassificationTrainer``)."""

    def _train_epoch(self, epoch):
        self.reset_metrics_tracker()
        n_batches = len(self.train_loader)
        for batch_idx, batch in enumerate(self._batches(self.train_loader)):
            loss, n, *metrics = self._train_step(batch)
            self.train_loss.update(self.loss_name, loss, n=1)
            for name, value in zip(self.metric_names, metrics):
                self.train_metrics.update(name, value, n=int(n))
            if batch_idx % self.log_step == 0:
                self.log_for_step(epoch, batch_idx, n_batches)

        log = self.train_loss.result()
        log.update(self.train_metrics.result())

        if self.do_val and (epoch % self.val_step == 0):
            log.update(self._validate_epoch(epoch))

        if isinstance(self.lr_scheduler, _ReduceLROnPlateau):
            self.lr_scheduler.step(self.val_loss.avg(self.loss_name))
        return log

    def _validate_epoch(self, epoch, save_result=False):
        self.val_loss.reset()
        self.val_metrics.reset()
        self.logger.info("Validation: ")
        result = [] if save_result else None
        for batch_idx, batch in enumerate(self._batches(self.val_loader)):
            (loss, n, *metrics), pred, prob = self._eval_step(batch)
            self.val_loss.update(self.loss_name, loss, n=1)
            for name, value in zip(self.metric_names, metrics):
                self.val_metrics.update(name, value, n=int(n))
            if batch_idx % self.log_step == 0:
                self.logger.debug(
                    "{}/{}".format(batch_idx, len(self.val_loader)))
                self.logger.debug("{}: {}".format(
                    self.loss_name, self.val_loss.avg(self.loss_name)))
            if save_result:
                keep = (batch["weight"] > 0).cpu().numpy()
                result.append([
                    [p for p, k in zip(batch["path"], keep) if k],
                    batch["target"].cpu().numpy()[keep],
                    pred.cpu().numpy()[keep],
                    prob.cpu().numpy()[keep],
                ])

        log = self.val_loss.result()
        log.update(self.val_metrics.result())
        val_log = {"val_{}".format(k): v for k, v in log.items()}
        if save_result:
            return val_log, result
        return val_log

    def log_for_step(self, epoch, batch_idx, n_batches):
        self.logger.info(
            "Train Epoch: {} [{}]/[{}] with {}, Loss: {:.6f}".format(
                epoch, batch_idx, n_batches, self.loss_name,
                self.train_loss.avg(self.loss_name)))
        self.logger.info(", ".join(
            "{}: {:.6f}".format(x, self.train_metrics.avg(x))
            for x in self.metric_names))


class AugClassificationTrainer(ClassificationTrainer):
    """Online-augmentation trainer with a frozen encoder in the loop (the
    JAX package's ``AugClassificationTrainer``): the uint8 batch is
    augmented on the device (``facenet_aug``: one K1 launch a step), run
    through the frozen encoder, then classified by the trainable MLP.

    The encoder is ``config["trainer"]["encoders"][chosen_idx_enc]``
    built by ``models.build_model`` (its local weights, else seeded)
    unless one is given; it is put in eval mode with ``requires_grad``
    off and runs under ``torch.no_grad()``."""

    def __init__(self, config, model, loss=None, metrics=None,
                 optimizer=None, lr_scheduler=None, mesh=None, seed=123,
                 device="cuda", encoder=None):
        super().__init__(config, model, loss, metrics, optimizer,
                         lr_scheduler, mesh=mesh, seed=seed, device=device)
        if encoder is None:
            from .. import models as model_md

            idx_enc = config["trainer"]["chosen_idx_enc"]
            encoder_info = config["trainer"]["encoders"][idx_enc]
            encoder = model_md.build_model(encoder_info["name"],
                                           **encoder_info["args"])
        self.encoder = encoder.to(self.device).eval().requires_grad_(False)

    def _encode(self, x):
        with annotate("encode", self.device), torch.no_grad():
            return self.encoder(x).to(torch.float32)
