"""PyTorch + CUDA port of the face recognition stack.

Mirrors the layout of ``vn_celeb_face_recognition_tpu`` (``ops/``,
``models/``, ``pipeline/``, ``utils/``) and holds the hand-written Hopper
kernels under ``csrc/``. The package imports ``torch`` and never ``jax``;
the JAX package is the numerical reference its tests hold it to.

Importing the package loads no kernel: ``utils.kernels`` builds the CUDA
library the first time a kernel is launched on a CUDA tensor.
"""

__version__ = "0.1.0"
