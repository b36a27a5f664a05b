"""The online-aug training step, built in one place for the tools that
time it (counterpart of the JAX package's ``training/aug_step.py``).

The step is ``AugClassificationTrainer``'s (cfg/train_cfg_aug_emb_classify
.json): ``facenet_aug`` on the uint8 batch (one launch of kernel K1's
frames form on the card), a frozen encoder in bf16 under
``torch.no_grad()``, then the trainable MLP's weighted NLL, backward and
Adam (lr 1e-4, weight decay 1e-4). The generator given to the step draws
the augmentation, then the MLP's dropout masks, as the trainer's does.

    step, mlp, optimizer = make_aug_train_step(device="cuda")
    loss = step(mlp, optimizer, imgs_u8, target, weight, gen)
"""

import torch

from ..models.inception_resnet_v1 import InceptionResnetV1
from ..models.iresnet import iresnet100
from ..models.layers import seeded_init_
from ..models.mlp import MLPModel
from ..ops.augment import facenet_aug
from ..utils.device import select_device
from .losses import neg_log_llhood
from .optim import make_optimizer


def make_aug_train_step(enc_kind="iresnet100", num_classes=1001,
                        target_fs=112, seed=0, device="cuda"):
    """Build the online-aug train step and its initial state, on the card
    unless ``device`` is the CPU.

    ``enc_kind`` "iresnet100" (cfg/train_cfg_aug_emb_classify.json's
    ``chosen_idx_enc`` 2; it takes 112 px faces) or any other value for
    InceptionResnetV1, either seeded from ``seed`` and frozen. Returns
    ``(step, mlp, optimizer)``: ``step(mlp, optimizer, imgs_u8 [B, S, S,
    3] with S = target_fs, target [B], weight [B], gen)`` takes one
    optimizer step and returns the loss (a device scalar); ``step.encoder``
    is the frozen encoder."""
    device = select_device(device)
    if enc_kind == "iresnet100" and target_fs != 112:
        raise ValueError(f"iresnet100 takes 112 px faces, not {target_fs}")
    gen = torch.Generator().manual_seed(seed)
    if enc_kind == "iresnet100":
        encoder = iresnet100(dtype=torch.bfloat16)
    else:
        encoder = InceptionResnetV1(dtype=torch.bfloat16)
    encoder = seeded_init_(encoder, gen).to(device).eval()
    encoder.requires_grad_(False)
    mlp = seeded_init_(MLPModel(512, num_classes), gen).to(device)
    optimizer = make_optimizer("Adam", {"lr": 1e-4, "weight_decay": 1e-4},
                               mlp.parameters())

    def step(mlp, optimizer, imgs_u8, target, weight, gen):
        x = facenet_aug(gen, imgs_u8)
        with torch.no_grad():
            emb = encoder(x.permute(0, 3, 1, 2)).to(torch.float32)
        mlp.train()
        loss = neg_log_llhood(mlp(emb, generator=gen), target, weight)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    step.encoder = encoder
    return step, mlp, optimizer
