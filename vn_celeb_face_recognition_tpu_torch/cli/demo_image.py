"""Single-image face recognition CLI on the port.

Counterpart of the repo-root ``demo_image.py``, with its flags: load a
detector (``-det`` + JSON args), an encoder (``-enc`` + JSON args), an MLP
classifier checkpoint (``-m``), optionally the emotion model
(``--recog_emotion``), run one image through the sequential or parallel
detect -> align -> embed -> classify pipeline and write the annotated
image. The models run on ``-dv`` (``cuda`` unless ``cpu`` is passed).

  python -m vn_celeb_face_recognition_tpu_torch.cli.demo_image -i face.png \\
      -l2n meta_data/face_recognition/label2name.txt -m model_best.pth

With ``--fan_weights`` (a torch-keyed 2DFAN4 ``.npz``) the sequential
method takes its landmarks from the FAN 68-point network, in
``--fan_dtype``. Drawing and writing the picture need cv2;
``recognize_image`` does not.
"""

import argparse

import numpy as np

from .. import models as model_md
from ..pipeline import (
    Classifier,
    EmotionModel,
    Encoder,
    center_point_dict,
    draw_boxes_on_image,
    draw_emotions,
    parallel_detect_and_align,
    recognize_celeb,
    recognize_emotion,
    sequential_detect_and_align,
    write_image,
)
from ..utils.device import select_device
from ..utils.frames import read_image
from ..utils.io import load_pickle, read_json, read_label2name


def build_arg_parser():
    p = argparse.ArgumentParser(
        description="Face recognition on a image (PyTorch port)"
    )
    p.add_argument("-fs", "--face_size", default=160, type=int)
    p.add_argument("-mfs", "--min_face_size", default=50, type=int)
    p.add_argument("-i", "--image_path", default="demo.png", type=str)
    p.add_argument("-o", "--output_path", default="demo_recognition.png",
                   type=str)
    p.add_argument("-m", "--classify_model", default="model_best.pth",
                   type=str)
    p.add_argument("-l2n", "--label2name", default="label2name.csv",
                   type=str)
    p.add_argument("-w", "--pre_trained_emb", default="vggface2", type=str)
    p.add_argument("-dv", "-d", "--device", default="cuda", type=str,
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("-id", "--input_dim_emb", default=512, type=int)
    p.add_argument("-nc", "--num_classes", default=1001, type=int)
    p.add_argument("-enc", "--encoder", default="InceptionResnetV1",
                   type=str)
    p.add_argument("-det", "--detection", default="MTCNN", type=str)
    p.add_argument("-eargs", "--encoder_args",
                   default="cfg/embedding/iresnet100_enc.json", type=str)
    p.add_argument("-dargs", "--detection_args",
                   default="cfg/detection/mtcnn.json", type=str)
    p.add_argument("-tg_fs", "--target_face_size", default=112, type=int)
    p.add_argument("--inference_method", default="seq_fd_vs_aln", type=str)
    p.add_argument("--min_dim_box", default=50, type=int)
    p.add_argument("--box_ratio", default=2.0, type=float)
    p.add_argument("--recog_threshold", default=0.0, type=float)
    p.add_argument("--recog_emotion", action="store_true")
    p.add_argument("-emt", "--emotion", default="resnet_2branch_50",
                   type=str)
    p.add_argument("-emtargs", "--emotion_args",
                   default="cfg/emotion/resnet50_2_branch.json", type=str)
    p.add_argument("-t2i", "--etag2idx_file",
                   default="meta_data/emotion_recognition/etag2idx.pkl",
                   type=str)
    p.add_argument("--topk_emotions", default=6, type=int)
    p.add_argument("--fan_dtype", default=None, type=str,
                   help="FAN compute dtype, e.g. bfloat16")
    p.add_argument("--fan_weights", default=None, type=str,
                   help="a torch-keyed 2DFAN4 .npz: seq_fd_vs_aln takes its "
                        "landmarks from the FAN 68-point network")
    return p


def build_fan_model(args):
    """The FAN landmarker of ``--fan_weights`` (compute dtype
    ``--fan_dtype``) on ``args.device``, or None without the flag."""
    if not getattr(args, "fan_weights", None):
        return None
    return model_md.FANLandmarker(weights_path=args.fan_weights,
                                  dtype=getattr(args, "fan_dtype", None),
                                  device=args.device)


def _reconcile_encoder_args(args, enc_args):
    """Make the stock flag defaults runnable: ``-enc`` defaults to
    InceptionResnetV1 but ``-eargs`` to the iresnet100 config. For
    InceptionResnetV1, drop the iresnet-only keys, map a boolean
    ``pretrained`` onto the ``-w`` dataset name, and route a non-empty
    ``checkpoint_path`` to ``weights_path``. Coherent ``-enc``/``-eargs``
    pairs pass through untouched."""
    if args.encoder != "InceptionResnetV1":
        return enc_args
    out = dict(enc_args)
    dropped = [k for k in ("progress", "freeze_weights") if k in out]
    for k in dropped:
        out.pop(k)
    ckpt = out.pop("checkpoint_path", "")
    if ckpt and "weights_path" not in out:
        out["weights_path"] = ckpt
    pre = out.get("pretrained")
    if isinstance(pre, bool):
        out["pretrained"] = (
            getattr(args, "pre_trained_emb", "vggface2") if pre else None
        )
    if dropped or isinstance(pre, bool):
        print(
            "Reconciled encoder args for InceptionResnetV1 "
            "(reference default -eargs is the iresnet config): "
            "dropped {}, pretrained -> {}".format(
                dropped, out.get("pretrained"))
        )
    return out


def setup_models(args):
    """The models the image, video and statistic CLIs share, on
    ``args.device``: (label -> name dict, detector, encoder, classifier,
    emotion model or None, emotion index -> tag or None)."""
    device = args.device
    label2name = read_label2name(args.label2name)
    det_args = read_json(args.detection_args)
    det_args.pop("device", None)
    detection_md = model_md.build_detector(args.detection, device=device,
                                           **det_args)

    enc_args = _reconcile_encoder_args(args, read_json(args.encoder_args))
    emb_model = Encoder.build(args.encoder, device=device, **enc_args)

    classify_model = Classifier.build(
        args.input_dim_emb, args.num_classes,
        checkpoint_path=args.classify_model, device=device,
    )

    emt_model, idx2etag = None, None
    if getattr(args, "recog_emotion", False):
        idx2etag = load_pickle(args.etag2idx_file)["idx2key"]
        emt_args = read_json(args.emotion_args)
        emt_args.pop("device", None)
        emt_model = EmotionModel.build(args.emotion, device=device,
                                       **emt_args)
    return label2name, detection_md, emb_model, classify_model, \
        emt_model, idx2etag


def recognize_image(args, models, rgb_image, fa_model=None):
    """One RGB uint8 image through detect -> align -> embed -> classify
    (and the emotion head with ``--recog_emotion``). With
    ``seq_fd_vs_aln`` the landmarks come from ``fa_model``, or from a FAN
    landmarker built for ``--fan_weights`` when none is given. Returns
    (names, boxes, emotion tags, emotion probabilities); the last two are
    None without ``--recog_emotion``."""
    (label2name, detection_md, emb_model, classify_model, emt_model,
     idx2etag) = models
    target_fs = (args.target_face_size, args.target_face_size)
    center_point = center_point_dict[str(target_fs)]
    rgb_images = [rgb_image]

    if args.inference_method == "seq_fd_vs_aln":
        box_requirements = {
            "min_dim": args.min_dim_box,
            "box_ratio": args.box_ratio,
        }
        bth_alg_faces, bth_chosen_boxes = sequential_detect_and_align(
            rgb_images, detection_md, center_point, target_fs,
            box_requirements, True,
            fa_model=fa_model or build_fan_model(args),
        )
    elif args.inference_method == "par_fd_vs_aln":
        bth_alg_faces, bth_chosen_boxes = parallel_detect_and_align(
            rgb_images, detection_md, center_point, target_fs, True
        )
    else:
        raise SystemExit(
            "Do not support {} method.".format(args.inference_method)
        )

    names = recognize_celeb(
        bth_alg_faces, None, emb_model, classify_model, None,
        label2name, args.recog_threshold,
    )[0]
    emotions = probs = None
    if args.recog_emotion:
        map_func = np.vectorize(lambda x: idx2etag[x])
        bth_emotions, bth_probs = recognize_emotion(
            bth_alg_faces, None, emt_model, None, map_func,
            args.topk_emotions,
        )
        emotions, probs = bth_emotions[0], bth_probs[0]
    return names, bth_chosen_boxes[0], emotions, probs


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    select_device(args.device)
    models = setup_models(args)
    rgb_image = read_image(args.image_path)
    names, chosen_boxes, emotions, probs = recognize_image(args, models,
                                                           rgb_image)

    np_image = np.ascontiguousarray(rgb_image[..., ::-1])  # BGR for cv2
    np_image_recog = draw_boxes_on_image(np_image, chosen_boxes, names)
    if emotions is not None:
        np_image_recog = draw_emotions(np_image_recog, chosen_boxes,
                                       emotions, probs)
    write_image(args.output_path, np_image_recog)
    print("Face recognized image saved at {} ...".format(args.output_path))
    return names, chosen_boxes


if __name__ == "__main__":
    main()
