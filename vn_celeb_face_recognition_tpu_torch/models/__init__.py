"""NCHW ``nn.Module``s with the torch reference's state_dict keys, and the
model registry.

``build_model(name, **args)`` and ``build_detector(name, **args)`` resolve
the names that config files use, as the JAX package's registry
(``vn_celeb_face_recognition_tpu/models/__init__.py``) does. Where that one
returns ``(module, variables)``, ``build_model`` returns the module with its
weights in it: pretrained weights from a local file when the arguments ask
for them and one is found (nothing is downloaded), else a seeded
initialisation (``layers.seeded_init_`` with ``torch.Generator`` seed 0).
"""

import os

import torch

from .inception_resnet_v1 import InceptionResnetV1
from .iresnet import _DEPTH_LAYERS, IResNet, iresnet34, iresnet50, iresnet100
from .layers import coerce_dtype, read_state_dict, seeded_init_
from .mlp import MLPModel
from .mtcnn import MTCNN
from .resnet_2_branch import ResNet2Branch, resnet_2branch_50
from .retinaface import RetinaFace, RetinaFaceNet

_JAX_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "vn_celeb_face_recognition_tpu", "models", "weights")
_FACENET_FILES = {
    "vggface2": "20180402-114759-vggface2",
    "casia-webface": "20180408-102900-casia-webface",
}
# the classes of the published facenet heads
_FACENET_CLASSES = {"vggface2": 8631, "casia-webface": 10575}


def _torch_checkpoints():
    return os.path.join(os.path.expanduser(os.getenv(
        "TORCH_HOME", os.path.join(os.getenv("XDG_CACHE_HOME", "~/.cache"),
                                   "torch"))), "checkpoints")


def _seeded(module):
    return seeded_init_(module, torch.Generator().manual_seed(0))


def _load_first(module, candidates, skip=()):
    """Load the first existing file of ``candidates`` into ``module``
    (strictly, without the keys under the ``skip`` prefixes). Returns
    whether one was found."""
    for path in candidates:
        if path and os.path.exists(path):
            sd = {k: v for k, v in read_state_dict(path).items()
                  if not k.startswith(tuple(skip))}
            module.load_state_dict(sd, strict=True)
            return True
    return False


def _no_head(what, **head):
    given = {k: v for k, v in head.items() if v}
    if given:
        raise NotImplementedError(
            f"{what} with a classification head ({given}) is a training "
            "configuration; the port builds the embedding encoder only")


def _facenet_candidates(pretrained, weights_path=None):
    if weights_path:
        return [weights_path]
    stem = _FACENET_FILES[pretrained]
    return [os.path.join(_JAX_WEIGHTS, stem + ".npz"),
            os.path.join(_torch_checkpoints(), stem + ".npz"),
            os.path.join(_torch_checkpoints(), stem + ".pt")]


def _iresnet_candidates(depth, weights_path=None, checkpoint_path=""):
    stem = f"iresnet{depth}.npz"
    return [c for c in (weights_path, checkpoint_path) if c] + [
        os.path.join(_JAX_WEIGHTS, stem),
        os.path.join(_torch_checkpoints(), stem)]


def local_weights(name, pretrained):
    """The local file that ``build_model(name, pretrained=...)`` loads for
    an encoder's published weights (``pretrained`` a facenet dataset name
    for InceptionResnetV1, True for the iresnets), or None when no such
    file exists; nothing is downloaded."""
    if name == "InceptionResnetV1":
        if pretrained not in _FACENET_FILES:
            raise ValueError('Pretrained models only exist for "vggface2" '
                             'and "casia-webface"')
        candidates = _facenet_candidates(pretrained)
    elif name.startswith("iresnet") and name[7:].isdigit():
        candidates = _iresnet_candidates(int(name[7:]))
    else:
        raise KeyError(f"no published weights for {name!r}")
    return next((c for c in candidates if os.path.exists(c)), None)


def _build_inception_resnet_v1(pretrained=None, classify=False,
                               num_classes=None, dropout_prob=0.6,
                               device=None, weights_path=None, dtype=None):
    """The JAX constructor's semantics: ``num_classes`` is required for a
    classify head without ``pretrained``; with ``pretrained`` the head has
    the dataset's class count unless ``classify`` and ``num_classes`` are
    both given. Local weights load the trunk strictly, and the head only
    when it keeps the dataset's class count (else it is seeded afresh)."""
    if pretrained is not None and pretrained not in _FACENET_FILES:
        raise ValueError('Pretrained models only exist for "vggface2" and '
                         '"casia-webface"')
    if pretrained is None and classify and num_classes is None:
        raise ValueError('If "pretrained" is not specified and "classify" '
                         'is True, "num_classes" must be specified')
    n_cls = num_classes
    if pretrained is not None and not (classify and num_classes):
        n_cls = _FACENET_CLASSES[pretrained]
    module = InceptionResnetV1(classify=classify,
                               num_classes=n_cls if classify else None,
                               dropout_prob=dropout_prob,
                               dtype=coerce_dtype(dtype))
    if pretrained is None:
        return _seeded(module)
    candidates = _facenet_candidates(pretrained, weights_path)
    path = next((c for c in candidates if c and os.path.exists(c)), None)
    if path is None:
        print(f"Warning: pretrained='{pretrained}' requested but no local "
              f"weights found (searched {candidates}); "
              "the encoder is randomly initialised. Convert the published "
              "torch checkpoint with tools/convert_weights.py.")
        return _seeded(module)
    sd = read_state_dict(path)
    head = module.logits
    if head is not None and (num_classes is None
                             or num_classes == _FACENET_CLASSES[pretrained]):
        module.load_state_dict(sd, strict=True)  # the published head
        return module
    trunk = {k: v for k, v in sd.items() if not k.startswith("logits.")}
    missing, unexpected = module.load_state_dict(trunk, strict=False)
    if unexpected or any(not k.startswith("logits.") for k in missing):
        raise RuntimeError(f"{path} does not fit InceptionResnetV1: missing "
                           f"{missing}, unexpected {unexpected}")
    if head is not None:  # a fresh head, as the reference re-initialises
        seeded_init_(head, torch.Generator().manual_seed(0))
    return module


def _build_iresnet(depth, pretrained=False, checkpoint_path="",
                   freeze_weights=False, n_classes=None, num_features=512,
                   weights_path=None, dtype=None):
    _no_head(f"iresnet{depth}", n_classes=n_classes)
    if num_features != 512:
        raise NotImplementedError(
            f"iresnet{depth} is ported with 512 features, not {num_features}")
    module = IResNet(_DEPTH_LAYERS[depth], dtype=coerce_dtype(dtype))
    if not pretrained:
        return _seeded(module)
    candidates = _iresnet_candidates(depth, weights_path, checkpoint_path)
    if not _load_first(module, candidates, skip=("logits.",)):
        print(f"Warning: pretrained iresnet{depth} requested but no local "
              "weights found; the encoder is randomly initialised. Convert "
              "the published torch checkpoint with tools/convert_weights.py.")
        _seeded(module)
    return module


def _build_resnet_2branch_50(pretrained=False, checkpoint_path=None,
                             num_classes=1000, num_projections=300,
                             weights_path=None, dtype=None):
    if num_projections != 300:
        raise NotImplementedError(
            f"the emotion head is ported with 300 projections, not "
            f"{num_projections}")
    module = resnet_2branch_50(num_classes=num_classes,
                               dtype=coerce_dtype(dtype))
    if not _load_first(module, (weights_path, checkpoint_path)):
        _seeded(module)
    return module


def _build_resnet101(**kwargs):
    raise NotImplementedError(
        "resnet101 (the SE-IR encoder) is not ported yet (ROADMAP.md, A.10)")


def _build_mlp(input_dim, num_classes, dropout_prob=0.5):
    return _seeded(MLPModel(input_dim, num_classes, dropout_prob))


_BUILDERS = {
    "MLPModel": _build_mlp,
    "InceptionResnetV1": _build_inception_resnet_v1,
    "iresnet34": lambda **kw: _build_iresnet(34, **kw),
    "iresnet50": lambda **kw: _build_iresnet(50, **kw),
    "iresnet100": lambda **kw: _build_iresnet(100, **kw),
    "resnet101": _build_resnet101,
    "resnet_2branch_50": _build_resnet_2branch_50,
}


def build_model(name, **args):
    """The module a registry name and its config's arguments describe, in
    eval mode on the CPU, with its weights loaded or seeded."""
    if name not in _BUILDERS:
        raise KeyError(f"Unknown model '{name}'")
    # config files carry torch-hub's download-progress flag
    # (cfg/embedding/iresnet100_enc.json); nothing is downloaded
    args.pop("progress", None)
    if "dtype" in args:
        args["dtype"] = coerce_dtype(args["dtype"])
    return _BUILDERS[name](**args).eval()


def build_detector(name, **args):
    """Detector factory (MTCNN / RetinaFace); a detector runs on the card
    unless ``device="cpu"`` is passed."""
    detectors = {"MTCNN": MTCNN, "RetinaFace": RetinaFace}
    if name not in detectors:
        raise KeyError(f"Unknown detector '{name}'")
    if "dtype" in args:
        args["dtype"] = coerce_dtype(args["dtype"])
    return detectors[name](**args)


__all__ = [
    "IResNet",
    "InceptionResnetV1",
    "iresnet34",
    "iresnet50",
    "iresnet100",
    "MLPModel",
    "MTCNN",
    "ResNet2Branch",
    "resnet_2branch_50",
    "RetinaFace",
    "RetinaFaceNet",
    "build_model",
    "build_detector",
    "local_weights",
]
