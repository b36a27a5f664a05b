"""Batch face-alignment CLI for dataset preparation, on the port.

Counterpart of the repo-root ``align_face.py``, with its flags: align every
image of a directory to ``-as W H`` by 5-point landmarks (the canonical
template of that size), writing each under the input's file name.
Landmarks come from the detector (MTCNN's ONet by default), or from the FAN
68-point network reduced to 5 with ``--fan_weights`` (a torch-keyed 2DFAN4
``.npz``, computed in ``--fan_dtype``), on the detector's first box or the
whole image. An image without usable landmarks is retried under a Gaussian
blur of sigma 0, 0.3, ..., 3; the first blur that gives landmarks ends the
sweep, and they are used if they pass the geometric sanity gate. An image
still without a face is resized (bicubic) to the output size as it is and
listed in ``-nf``.

The detector, FAN and the warp (K1's windows form, ``pipeline.align.
alignment`` on the BGR image) run on ``-dv`` (``cuda`` unless ``cpu`` is
passed); reading, blurring, resizing and writing use cv2, which keeps each
file's format (JPEG outputs are lossy).

  python -m vn_celeb_face_recognition_tpu_torch.cli.align_face \\
      -id cropped -od aligned -as 112 112 [--fan_weights 2DFAN4.npz]
"""

import argparse
import os
from pathlib import Path

import numpy as np

from .. import models as model_md
from ..pipeline import alignment, center_point_dict
from ..pipeline.recognition import landmarks_geometrically_sane
from ..utils.device import select_device
from ..utils.io import read_json
from ..utils.tracing import timed_stage


def gaussian_blur(img, sigma):
    import cv2

    if sigma <= 0:
        return img
    k = int(2 * round(3 * sigma) + 1)
    return cv2.GaussianBlur(img, (k, k), sigma)


def detect_landmarks(detector, rgb_image, fa_model=None, timer=None):
    """5-point landmarks of the (first) face, or None when there are none
    usable: FAN's 68 points reduced to 5 (None unless they pass the sanity
    gate) on the detector's first box, or on the whole image when the
    detector finds none, with ``fa_model``; the detector's own points
    otherwise."""
    with timed_stage(timer, "detect", detector.device):
        boxes, _, points = detector.inference(rgb_image, landmark=True)
    if fa_model is not None:
        from ..models import fan

        box = None
        if len(boxes) > 0:
            box = np.asarray(boxes[0][:4], np.float32)
        with timed_stage(timer, "fan", fa_model.device):
            pts68 = fa_model.get_landmarks(rgb_image, detected_box=box)[0]
        dst, sane = fan.reduce_to_5_points(pts68)
        return np.asarray(dst, np.float32) if sane else None
    if len(boxes) == 0:
        return None
    return np.asarray(points[0], dtype=np.float32)


def face_image_from_landmarks(center_points, dst, img_rgb, output_dir,
                              img_file, aligned_size, device="cuda",
                              timer=None):
    import cv2

    cv_img = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR)
    with timed_stage(timer, "warp", device):
        face_resized = alignment(cv_img, center_points, dst,
                                 aligned_size[0], aligned_size[1],
                                 device=device)
    with timed_stage(timer, "write"):
        cv2.imwrite(str(Path(output_dir) / img_file), face_resized)
    print("Finding face for {} is done ...".format(img_file))


def align_face(input_dir, output_dir, aligned_size, detector,
               center_points, unknown_file, fa_model=None, timer=None):
    """Align every image of ``input_dir`` into ``output_dir`` (the warp on
    the detector's device); returns the counts {total, no_face}.
    ``timer`` (a ``utils.tracing.StageTimer``) times the read, detect, fan,
    warp and write stages."""
    import cv2

    device = detector.device
    n_no_face = 0
    total = 0
    img_files = sorted(os.listdir(input_dir))
    n_images = len(img_files)
    input_dir = Path(input_dir)
    output_dir = Path(output_dir)
    for idx, img_file in enumerate(img_files):
        img_path = str(input_dir / img_file)
        output_path = str(output_dir / img_file)
        print("---------{}/{}---------".format(idx, n_images))
        if os.path.exists(output_path):
            continue
        print("Processing {}".format(img_path))
        with timed_stage(timer, "read"):
            bgr_image = cv2.imread(img_path)
        rgb_image = cv2.cvtColor(bgr_image, cv2.COLOR_BGR2RGB)

        have_face = False
        dst = detect_landmarks(detector, rgb_image, fa_model, timer)
        if dst is None:
            print("Step 1: unknown {}".format(img_path))
            for sigma in np.linspace(0.0, 3.0, num=11):
                image_aug = gaussian_blur(rgb_image, float(sigma))
                dst = detect_landmarks(detector, image_aug, fa_model, timer)
                if dst is not None:
                    print("sigma {} help finding face".format(sigma))
                    if landmarks_geometrically_sane(dst):
                        face_image_from_landmarks(
                            center_points, dst, rgb_image, output_dir,
                            img_file, aligned_size, device, timer,
                        )
                        have_face = True
                    break
        else:
            face_image_from_landmarks(center_points, dst, rgb_image,
                                      output_dir, img_file, aligned_size,
                                      device, timer)
            have_face = True

        if not have_face:
            n_no_face += 1
            print("{} has no face".format(img_path))
            unknown_file.write(img_path + "\n")
            face_resized = cv2.resize(bgr_image, aligned_size,
                                      interpolation=cv2.INTER_CUBIC)
            with timed_stage(timer, "write"):
                cv2.imwrite(str(output_dir / img_file), face_resized)
        total += 1
    print("No face: {}".format(n_no_face))
    print("Total images: {}".format(total))
    return {"total": total, "no_face": n_no_face}


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Face alignment to specific size by landmarks (PyTorch "
                    "port)"
    )
    parser.add_argument("-id", "--input_dir", default="test", type=str)
    parser.add_argument("-od", "--output_dir", default="test_aligned",
                        type=str)
    parser.add_argument("-as", "--aligned_size", nargs="+", type=int)
    parser.add_argument("-nf", "--un_face_file", default="unknown.txt",
                        type=str)
    parser.add_argument("-dv", "-d", "--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("-det", "--detection", default="MTCNN", type=str)
    parser.add_argument("-dargs", "--detection_args",
                        default="cfg/detection/mtcnn.json", type=str)
    parser.add_argument("--fan_dtype", default=None, type=str,
                        help="FAN compute dtype, e.g. bfloat16")
    parser.add_argument("--fan_weights", default=None, type=str,
                        help="a torch-keyed 2DFAN4 .npz: take the landmarks "
                             "from the FAN 68-point network")
    return parser


def main(argv=None, timer=None):
    args = build_arg_parser().parse_args(argv)
    select_device(args.device)
    if not os.path.exists(args.output_dir):
        os.makedirs(args.output_dir)

    det_args = read_json(args.detection_args)
    det_args.pop("device", None)
    detector = model_md.build_detector(args.detection, device=args.device,
                                       **det_args)

    fa_model = None
    if args.fan_weights:
        fa_model = model_md.FANLandmarker(weights_path=args.fan_weights,
                                          dtype=args.fan_dtype,
                                          device=args.device)

    aligned_size = tuple(args.aligned_size)
    center_point = center_point_dict[str(aligned_size)]
    with open(args.un_face_file, "w") as unknown_file:
        return align_face(args.input_dir, args.output_dir, aligned_size,
                          detector, center_point, unknown_file,
                          fa_model=fa_model, timer=timer)


if __name__ == "__main__":
    main()
