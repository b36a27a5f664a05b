"""Batch face-crop CLI for dataset preparation, on the port.

Counterpart of the repo-root ``crop_face.py``, with its flags: run a
detector (``-det`` + JSON args ``-dargs``) over every image of a directory,
save the first face crop of each under the output directory with the
input's file name, and list the problem files (unreadable or faceless in
``-nf``, several faces in ``-mf``). Outputs that already exist are skipped,
so an interrupted run resumes. The detector runs on ``-dv`` (``cuda``
unless ``cpu`` is passed); images are read and written with cv2, which
keeps each file's format (JPEG outputs are lossy).

  python -m vn_celeb_face_recognition_tpu_torch.cli.crop_face \\
      -id raw_images -od cropped -nf unknown.txt -mf many_boxes.txt
"""

import argparse
import os
from pathlib import Path

from .. import models as model_md
from ..utils.device import select_device
from ..utils.io import read_json
from ..utils.tracing import timed_stage


def clip_box_to_image(box, width, height):
    x1 = max(int(box[0]), 0)
    y1 = max(int(box[1]), 0)
    x2 = min(int(box[2] + 1), width)
    y2 = min(int(box[3] + 1), height)
    return x1, y1, x2, y2


def get_face_from_box(bgr_img, box):
    h, w = bgr_img.shape[:2]
    x1, y1, x2, y2 = clip_box_to_image(box, w, h)
    return bgr_img[y1:y2, x1:x2, :]


def crop_face(input_dir, output_dir, detection_md, unknown_file,
              many_boxes_file, timer=None):
    """Crop the first detected face of every image in ``input_dir`` into
    ``output_dir``; returns the counts {total, no_face, many_faces,
    skipped}. ``timer`` (a ``utils.tracing.StageTimer``) times the read,
    detect and write stages."""
    import cv2

    stats = {"total": 0, "no_face": 0, "many_faces": 0, "skipped": 0}
    in_root, out_root = Path(input_dir), Path(output_dir)
    entries = sorted(os.listdir(input_dir))
    for idx, name in enumerate(entries):
        stats["total"] += 1
        print(f"---------{idx}/{len(entries)}---------")
        destination = out_root / name
        if destination.exists():
            stats["skipped"] += 1
            continue
        source = in_root / name
        print(f"Processing {source}")
        with timed_stage(timer, "read"):
            bgr = cv2.imread(str(source))
        if bgr is None:
            unknown_file.write(f"{source}\n")
            stats["no_face"] += 1
            continue
        with timed_stage(timer, "detect"):
            detections, _ = detection_md.inference(
                cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), landmark=False
            )
        if len(detections) == 0:
            unknown_file.write(f"{source}\n")
            stats["no_face"] += 1
            continue
        if len(detections) > 1:
            many_boxes_file.write(f"{source}\n")
            stats["many_faces"] += 1
        with timed_stage(timer, "write"):
            cv2.imwrite(str(destination), get_face_from_box(bgr,
                                                            detections[0]))
        print(f"Finding face for {name} is done ...")

    print(f"Total images: {stats['total']}.")
    print(f"No face images: {stats['no_face']}.")
    print(f"Many face images: {stats['many_faces']}.")
    return stats


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Crop faces over a directory with a detector (PyTorch "
                    "port)"
    )
    parser.add_argument("-id", "--input_dir", default="test")
    parser.add_argument("-od", "--output_dir", default="test_aligned")
    parser.add_argument("-nf", "--un_face_file", default="unknown.txt")
    parser.add_argument("-mf", "--many_boxes_file",
                        default="many_boxes.txt")
    parser.add_argument("-det", "--detection", default="MTCNN")
    parser.add_argument("-dargs", "--detection_args",
                        default="cfg/detection/mtcnn.json")
    parser.add_argument("-dv", "-d", "--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def main(argv=None, timer=None):
    args = build_arg_parser().parse_args(argv)
    select_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    detector_kwargs = read_json(args.detection_args)
    detector_kwargs.pop("device", None)
    detector = model_md.build_detector(args.detection, device=args.device,
                                       **detector_kwargs)

    with open(args.un_face_file, "w") as unknown_file, \
            open(args.many_boxes_file, "w") as many_boxes_file:
        return crop_face(args.input_dir, args.output_dir, detector,
                         unknown_file, many_boxes_file, timer=timer)


if __name__ == "__main__":
    main()
