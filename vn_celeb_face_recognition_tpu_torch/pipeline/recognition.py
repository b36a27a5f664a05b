"""Inference pipeline library: detect and align single images, recognise
and emotion-tag their faces.

Counterpart of ``vn_celeb_face_recognition_tpu/pipeline/recognition.py``,
with its signatures and numpy return types:

  * ``Encoder`` / ``Classifier`` / ``EmotionModel`` wrap a module on a
    device (the card unless ``device="cpu"`` is passed): NHWC float numpy
    in, through the wrapper's ``transform``, numpy out. PyTorch runs
    eagerly, so batches are not padded to buckets. With ``mesh=`` (the
    counterpart of ``_JitApply(mesh=)``) a batch is padded with copies of
    its first row to a multiple of the mesh's ``n_data``, each data rank
    applies the module to its block, and the blocks are all-gathered and
    cut back to the batch, on every rank;
  * ``sequential_detect_and_align`` and ``parallel_detect_and_align`` run
    the detector's ``inference`` once for the call (MTCNN: kernels K4, K2,
    K3 and K5; RetinaFace: K6 and K3), gather every kept crop of every
    image, and align them all in one ``align_crops`` call (K1's windows
    form);
  * ``recognize_celeb`` embeds and classifies every aligned face of a call
    in one batch; ``recognize_emotion`` runs the 2-branch emotion net on
    faces (K7 for 112 px faces, and K8);
  * ``identify_person`` takes the JAX package's name table (anything
    indexed as ``df["name"][df["label"] == label]``, a pandas DataFrame for
    one, which this module does not import) or a plain ``{label: name}``
    dict.

The library's stages (detect, fan, align, embed, classify, emotion) are
spans for ``torch.profiler`` (NVTX ranges under ``emit_nvtx``), and timed
by a ``utils.tracing.StageTimer`` when one is passed as ``timer``.

The landmarks are the detector's own 5 points or, in
``sequential_detect_and_align`` with ``fa_model`` (a
``models.fan.FANLandmarker``), FAN's 68 points reduced to 5, every face
crop of the call in one FAN batch.
"""

import numpy as np
import torch
from torch import nn

from ..data.transforms import transform_emotion_inf, transforms_dict
from ..models.layers import read_state_dict
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import replicate
from ..training.checkpoint import load_checkpoint, load_state_dict_from_jax
from ..utils.device import select_device
from ..utils.tracing import timed_stage
from .align import align_crops, pad_windows


class _Apply(nn.Module):
    """A module on a device behind a batched NHWC transform: float numpy
    in, numpy out (a tuple for a module with several outputs). Under a
    ``mesh`` the module runs on the mesh's device, its weights replicated
    from rank 0, and each rank applies it to its data block."""

    def __init__(self, module, transform=None, device="cuda", mesh=None):
        super().__init__()
        self.mesh = mesh
        self.device = (select_device(device) if mesh is None
                       else mesh.device)
        self.module = module.to(self.device).eval()
        if mesh is not None:
            replicate(mesh, self.module)
        self.transform = transform

    @property
    def dtype(self):
        """The module's compute dtype."""
        return getattr(self.module, "dtype", torch.float32)

    def _run(self, x):
        return self.module(x)

    def _apply_block(self, x):
        """The module's output(s) on a device batch."""
        if self.transform is not None:
            x = self.transform(x, None)
        return self._run(x)

    @torch.no_grad()
    def forward(self, x):
        x = np.asarray(x, np.float32)
        n = len(x)
        mesh = self.mesh
        if mesh is not None:
            n_pad = -(-n // mesh.n_data) * mesh.n_data
            if n_pad != n:
                x = np.concatenate([x, np.repeat(x[:1], n_pad - n, axis=0)])
            block = n_pad // mesh.n_data
            x = x[mesh.d * block:(mesh.d + 1) * block]
        out = self._apply_block(torch.as_tensor(x, device=self.device))
        outs = out if isinstance(out, tuple) else (out,)
        if mesh is not None:
            outs = tuple(all_gather_rows(o, mesh.data_group)[:n]
                         for o in outs)
        outs = tuple(o.to(torch.float32).cpu().numpy() for o in outs)
        return outs if isinstance(out, tuple) else outs[0]


class Encoder(_Apply):
    """Face embedding model wrapper (InceptionResnetV1 / iresnet...).

    Takes NHWC faces; the wrapper's ``transform`` (``recognize_celeb`` sets
    the default fix_std) runs before the NCHW encoder."""

    def _run(self, x):
        return self.module(x.permute(0, 3, 1, 2))

    @classmethod
    def build(cls, name, device="cuda", **args):
        from ..models import build_model

        return cls(build_model(name, **args), device=device)


class Classifier(_Apply):
    """MLP log-softmax classifier wrapper."""

    @classmethod
    def build(cls, input_dim, num_classes, checkpoint_path=None,
              device="cuda"):
        from ..models import build_model

        clf = cls(build_model("MLPModel", input_dim=input_dim,
                              num_classes=num_classes), device=device)
        if checkpoint_path:
            load_model_classify(checkpoint_path, clf)
        return clf


class EmotionModel(_Apply):
    """2-branch emotion model wrapper; returns (logits, projection).

    ``transform`` must be ``emotion_inf`` (``recognize_emotion`` sets it):
    the 224 px area resize and the ImageNet normalisation, as in the JAX
    package. For 112 px faces the net computes that transform inside its
    stem, kernel K7. Faces of any other size go through the transform on
    the device, then the net's own stem in cuDNN
    (``ResNet2Branch.forward_normalized``)."""

    FACE_SIZE = 112

    @torch.no_grad()
    def forward(self, x):
        if self.transform is not transform_emotion_inf:
            raise ValueError(
                "EmotionModel runs the emotion_inf transform (inside its "
                "stem, kernel K7, for 112 px faces); set transform to "
                "transforms_dict['emotion_inf'], got "
                f"{getattr(self.transform, '__name__', self.transform)!r}")
        x = np.asarray(x, np.float32)
        if x.ndim != 4 or x.shape[3] != 3:
            raise ValueError(f"EmotionModel takes [K, H, W, 3] faces, got "
                             f"{list(x.shape)}")
        return super().forward(x)

    def _apply_block(self, x):
        if x.shape[1:3] == (self.FACE_SIZE, self.FACE_SIZE):
            return self.module(x)
        return self.module.forward_normalized(self.transform(x))

    @classmethod
    def build(cls, name="resnet_2branch_50", device="cuda", **args):
        from ..models import build_model

        return cls(build_model(name, **args), device=device)


def load_model_classify(checkpoint_path, model):
    """Load a classifier checkpoint into a Classifier: a JAX checkpoint
    (the one-pickle format), or a torch ``.pth``/``.pt`` state_dict of the
    same MLP."""
    if str(checkpoint_path).endswith((".pth", ".pt")):
        model.module.load_state_dict(read_state_dict(checkpoint_path),
                                     strict=True)
        print("Loading torch checkpoint: {} ...".format(checkpoint_path))
        return model
    cp = load_checkpoint(checkpoint_path)
    print(
        "Loading checkpoint: {} ... after training for {} epochs.".format(
            checkpoint_path, cp["epoch"]
        )
    )
    load_state_dict_from_jax(model.module, cp["state_dict"])
    return model


# ---------------------------------------------------------------------------
# Core recognition functions
# ---------------------------------------------------------------------------


def find_embedding(image_batch, embedding_model):
    """Embed a stacked float face batch."""
    return embedding_model(image_batch)


def find_emotion(image_batch, emotion_model, topk=6):
    """Top-k emotion classes + softmax probabilities."""
    logits, _ = emotion_model(image_batch)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = probs / probs.sum(axis=1, keepdims=True)
    chosen_idx = np.argsort(logits, axis=1)[:, -topk:]
    chosen_prob = np.sort(probs, axis=1)[:, -topk:]
    return np.flip(chosen_idx, axis=1), np.flip(chosen_prob, axis=1)


def _name_of(name_df, label):
    if isinstance(name_df, dict):
        return name_df.get(int(label), "Unknown")
    name = list(name_df["name"][name_df["label"] == label])
    return name[0] if name else "Unknown"


def identify_person(log_probs, classify_model, name_df, threshold):
    """argmax + exp(prob) + per-class threshold + label -> name lookup.
    ``log_probs`` may be embeddings (then the classifier runs) or
    already-computed log-probs with classify_model=None. ``threshold`` is
    a number or a dict keyed by ``str(label)``; ``name_df`` a name table
    or a ``{label: name}`` dict. A face under its threshold, or whose label
    has no name, is "Unknown"."""
    if classify_model is not None:
        output = classify_model(log_probs)
    else:
        output = np.asarray(log_probs)
    n_classes = output.shape[1]
    if isinstance(threshold, (int, float)):
        threshold_dict = {str(i): threshold for i in range(n_classes)}
    else:
        threshold_dict = threshold

    predictions = np.argmax(output, axis=1)
    probs = np.exp(output)
    chosen_prob = probs[np.arange(len(predictions)), predictions]

    filtered = []
    for idx, prob in enumerate(chosen_prob):
        main_thres = threshold_dict[str(predictions[idx])]
        filtered.append(
            predictions[idx] if prob >= main_thres else n_classes
        )
    return [_name_of(name_df, pred) for pred in filtered]


def _split(flat, bth_list):
    """Cut a flat per-face sequence back into the per-image lists."""
    out, counter = [], 0
    for x in bth_list:
        out.append(flat[counter: counter + len(x)])
        counter += len(x)
    return out


def _stack_faces(bth_alg_face_list):
    faces = [f for x in bth_alg_face_list for f in x]
    if not faces:
        return None
    return np.stack([np.asarray(f, dtype=np.float32) for f in faces])


def recognize_celeb(bth_alg_face_list, device, emb_model, classify_model,
                    transforms, label2name_df, threshold, timer=None):
    """Flatten the per-image aligned-face lists, transform + embed +
    classify in one batch, unflatten the names per image. ``transforms``
    is a batched transform (``data.transforms``) or None for the default
    fix_std. ``device`` is unused: each model runs on its own."""
    faces = _stack_faces(bth_alg_face_list)
    if faces is None:
        return [[] for _ in bth_alg_face_list]
    tf = transforms if transforms is not None else transforms_dict["default"]
    if emb_model.transform is None:
        emb_model.transform = tf
    with timed_stage(timer, "embed"):
        embeddings = find_embedding(faces, emb_model)
    with timed_stage(timer, "classify"):
        names = identify_person(embeddings, classify_model, label2name_df,
                                threshold)
    return _split(names, bth_alg_face_list)


def recognize_emotion(bth_alg_face_list, device, emt_model, transforms,
                      map_label_func, topk=6, timer=None):
    """The same flatten/unflatten pattern for the emotion head: per image,
    the top-k tags (``map_label_func`` of the class indices) and their
    probabilities. ``device`` is unused."""
    faces = _stack_faces(bth_alg_face_list)
    if faces is None:
        empty = [[] for _ in bth_alg_face_list]
        return empty, [[] for _ in bth_alg_face_list]
    if emt_model.transform is None:
        emt_model.transform = transforms or transforms_dict["emotion_inf"]
    with timed_stage(timer, "emotion"):
        emotions_cls, probs = find_emotion(faces, emt_model, topk)
    bth_emotions = [map_label_func(c) if len(c) else []
                    for c in _split(emotions_cls, bth_alg_face_list)]
    return bth_emotions, _split(probs, bth_alg_face_list)


# ---------------------------------------------------------------------------
# Drawing (cv2, host side)
# ---------------------------------------------------------------------------


def draw_boxes_on_image(image, boxes, list_names):
    import cv2

    np_image = np.array(image)
    for box, name in zip(boxes, list_names):
        p1 = (int(box[0]), int(box[1]))
        p2 = (int(box[2]), int(box[3]))
        cv2.rectangle(np_image, p1, p2, (0, 255, 0), 2)
        cv2.putText(np_image, name, (int(box[2]), int(box[1])),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.75, (0, 255, 0), 2,
                    cv2.LINE_AA)
    return np_image


def draw_emotions(image, bboxes, emotion_tags, emotion_percent):
    import cv2

    for idx, box in enumerate(bboxes):
        for i, (emotion, percent) in enumerate(
            zip(emotion_tags[idx], emotion_percent[idx])
        ):
            cv2.putText(
                image,
                "{} - {:.2f}%".format(emotion, percent * 100),
                (int(box[0] + 5), int(box[1]) + (i + 1) * 16),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1,
                cv2.LINE_AA,
            )
    return image


def write_image(path, bgr_image):
    """Write a drawn BGR image with ``cv2.imwrite`` (the format by the
    file's extension); raises when cv2 cannot write it."""
    import cv2

    if not cv2.imwrite(str(path), bgr_image):
        raise OSError(f"cv2.imwrite could not write {path}")


# ---------------------------------------------------------------------------
# Detect + align front ends
# ---------------------------------------------------------------------------


def get_face_from_boxes(image, boxes, box_requirements=None):
    """Crop faces with the min-dim / aspect-ratio gate."""
    list_faces, face_idx = [], []
    ori_h, ori_w = image.shape[:2]
    for idx, box in enumerate(boxes):
        x1 = max(int(box[0]), 0)
        y1 = max(int(box[1]), 0)
        x2 = min(int(box[2] + 1), ori_w)
        y2 = min(int(box[3] + 1), ori_h)
        w, h = x2 - x1, y2 - y1
        if w <= 0 or h <= 0:
            continue
        max_dim, min_dim = max(w, h), min(w, h)
        chosen = box_requirements is None or (
            min_dim > box_requirements["min_dim"]
            and max_dim / min_dim < box_requirements["box_ratio"]
        )
        if chosen:
            list_faces.append(image[y1:y2, x1:x2, :])
            face_idx.append(idx)
    return list_faces, face_idx


def move_landmark_to_box(box, landmark):
    """Shift frame-coordinate landmarks into the crop's frame."""
    return np.asarray(landmark) - np.asarray(box[:2])


def landmarks_geometrically_sane(pts):
    """Eye/nose/mouth vertical-ordering sanity check: eyes above nose,
    nose above mouth."""
    p1, p2, p3, p4, p5 = pts
    return (
        np.mean([p1[1], p2[1]]) < p3[1]
        and p3[1] < np.mean([p4[1], p5[1]])
        and min(p4[1], p5[1]) > max(p1[1], p2[1])
        and min(p1[1], p2[1]) < p3[1]
        and p3[1] < max(p4[1], p5[1])
    )


def _detect(rgb_images, detection_md, timer):
    if isinstance(rgb_images, np.ndarray) and rgb_images.ndim == 3:
        rgb_images = [rgb_images]
    with timed_stage(timer, "detect"):
        bth_boxes, _, bth_landmarks = detection_md.inference(
            rgb_images, landmark=True)
    return rgb_images, bth_boxes, bth_landmarks


def _align_all(crops, landmarks, per_image, center_point, target_fs,
               device, timer):
    """Align every gathered crop in one call and cut the faces back into
    per-image lists (``per_image`` holds each image's face count)."""
    with timed_stage(timer, "align"):
        faces = align_crops(crops, np.asarray(landmarks, np.float32).reshape(
            -1, 5, 2), center_point, target_fs, device=device)
    out, counter = [], 0
    for n in per_image:
        out.append(list(faces[counter:counter + n]))
        counter += n
    return out


def _fan_landmarks(fa_model, faces, timer):
    """FAN's landmarks of every face crop in one batch, each crop its own
    box (the zero padding of the batch reads as the crop's own zero
    border), reduced to 5 points: [(dst [5, 2], sane)]."""
    from ..models import fan

    if not faces:
        return []
    boxes = np.asarray([[0.0, 0.0, float(f.shape[1]), float(f.shape[0])]
                        for f in faces], np.float32)
    with timed_stage(timer, "fan"):
        points = fa_model.landmarks_for_boxes(pad_windows(faces), boxes)
    return [fan.reduce_to_5_points(p) for p in points]


def sequential_detect_and_align(rgb_images, detection_md, center_point,
                                target_fs, box_requirements=None,
                                log=False, fa_model=None, timer=None):
    """Detect boxes and landmarks, gate boxes, sanity-check landmarks,
    warp. Returns (per-image aligned-face lists, per-image chosen boxes).
    The landmarks are the detector's own 5 points, or with ``fa_model`` (a
    ``models.fan.FANLandmarker``) FAN's 68 points of each gated face crop
    reduced to 5 (``models.fan.reduce_to_5_points``), one FAN batch for
    the call."""
    rgb_images, bth_boxes, bth_landmarks = _detect(rgb_images, detection_md,
                                                   timer)
    gated = []  # per image: (face crops, their indices into the boxes)
    for idx, boxes in enumerate(bth_boxes):
        gated.append(get_face_from_boxes(np.asarray(rgb_images[idx]), boxes,
                                         box_requirements)
                     if len(boxes) > 0 else None)
    if fa_model is not None:
        fan_lms = iter(_fan_landmarks(
            fa_model, [f for g in gated if g for f in g[0]], timer))
    crops, lms, per_image, bth_chosen = [], [], [], []
    for idx, (boxes, landmarks) in enumerate(zip(bth_boxes, bth_landmarks)):
        chosen_boxes = []
        if gated[idx] is not None:
            list_face, face_idx = gated[idx]
            for j, face in enumerate(list_face):
                if fa_model is not None:
                    lm, sane = next(fan_lms)
                else:
                    lm = move_landmark_to_box(
                        boxes[face_idx[j]], landmarks[face_idx[j]]
                    )
                    sane = landmarks_geometrically_sane(lm)
                if not sane:
                    if log:
                        print("Landmarks failed the sanity check !")
                    continue
                crops.append(face)
                lms.append(lm)
                chosen_boxes.append(boxes[face_idx[j]])
            if log and not chosen_boxes:
                print(
                    "Bounding boxes were not qualified or could not "
                    "detect landmarks !"
                )
        elif log:
            print("Face not found in this image !")
        per_image.append(len(chosen_boxes))
        bth_chosen.append(chosen_boxes)
    bth_aligned = _align_all(crops, lms, per_image, center_point, target_fs,
                             detection_md.device, timer)
    return bth_aligned, bth_chosen


def parallel_detect_and_align(rgb_images, detection_md, center_point,
                              target_fs, log=False, timer=None):
    """One batched detector pass with its own landmarks, then one warp of
    every face. Returns (per-image aligned-face lists, per-image chosen
    boxes)."""
    rgb_images, bth_boxes, bth_landmarks = _detect(rgb_images, detection_md,
                                                   timer)
    crops, lms, per_image, bth_chosen = [], [], [], []
    for idx, (boxes, landmarks) in enumerate(zip(bth_boxes, bth_landmarks)):
        chosen_boxes = []
        rgb_image = np.asarray(rgb_images[idx])
        if len(boxes) > 0:
            list_face, face_idx = get_face_from_boxes(rgb_image, boxes)
            if len(face_idx) > 0:
                chosen_boxes = [boxes[x] for x in face_idx]
                for j, face in enumerate(list_face):
                    crops.append(face)
                    lms.append(move_landmark_to_box(
                        chosen_boxes[j], landmarks[face_idx[j]]))
            elif log:
                print(
                    "Bounding boxes were not qualified or could not "
                    "detect landmarks !"
                )
        elif log:
            print("Face not found in this image !")
        per_image.append(len(chosen_boxes))
        bth_chosen.append(chosen_boxes)
    bth_aligned = _align_all(crops, lms, per_image, center_point, target_fs,
                             detection_md.device, timer)
    return bth_aligned, bth_chosen
