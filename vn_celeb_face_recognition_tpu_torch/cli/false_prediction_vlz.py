"""False-prediction visualiser CLI, on the port (no pandas, no PIL).

Counterpart of the repo-root ``false_prediction_vlz.py``, with its flags,
files and printed lines: read ``result.csv`` (from ``cli.eval``), take the
rows whose Target differs from their Prediction, and draw for each a
3-panel figure (the input image, the first image of the target class and
the first of the predicted class, from the ``-dcrf`` manifest) to
``vlz_for_sample_{idx}.png`` in ``-ocnt``. The table is read with the
``csv`` module (each column typed as pandas types it), the images with
``utils.frames.read_image`` (PNG in Python; JPEG through the IO runtime or
cv2); a grey or palette PNG is shown as RGB, where the repo-root CLI hands
PIL's grey image to matplotlib's colour map. The figure is drawn with the
repo-root CLI's matplotlib calls, so it needs matplotlib (imported when a
figure is drawn). It does no device work.

  python -m vn_celeb_face_recognition_tpu_torch.cli.false_prediction_vlz \\
      -rp result.csv -dcrf vn_celeb.json -icnt train -ocnt output_vlz
"""

import argparse
import os

from ..utils.frames import read_image
from ..utils.io import read_csv_columns, read_json
from ..utils.misc import pyplot


def find_class_anchor(description_dict, class_idx, container):
    """The first image of class ``class_idx`` in the manifest, as
    [H, W, 3] uint8."""
    images4class = description_dict[str(class_idx)]
    return read_image(os.path.join(container, images4class[0]))


def create_image_to_compare(image_input, image_target, image_pred,
                            target_cls, pred_class, prob, input_path, idx,
                            output_container):
    plt = pyplot()
    fig, axes = plt.subplots(1, 3)
    image_name = input_path.split("/")[-1]
    axes[0].imshow(image_input)
    axes[1].imshow(image_target)
    axes[2].imshow(image_pred)
    title = (
        "Input image: {}; ".format(image_name)
        + "Target class index: {}; ".format(target_cls)
        + "Prediction class: {}, probability: {:.2f};".format(
            pred_class, prob)
    )
    output_path = os.path.join(output_container,
                               "vlz_for_sample_{}.png".format(idx))
    plt.title(title)
    plt.savefig(output_path, bbox_inches="tight")
    plt.close()


def visualize_false_prediction(result_path, description_dict,
                               img_container, output_container):
    os.makedirs(output_container, exist_ok=True)
    columns = read_csv_columns(result_path)
    miss = [t != p for t, p in zip(columns["Target"], columns["Prediction"])]
    rows = zip(*list(columns.values())[:4])
    misses = [row for row, m in zip(rows, miss) if m]
    for idx, (path, target, pred, prob) in enumerate(misses):
        create_image_to_compare(
            read_image(path),
            find_class_anchor(description_dict, target, img_container),
            find_class_anchor(description_dict, pred, img_container),
            target, pred, prob, path, idx, output_container)
        print("Save visualization for sample at: {}, {}".format(idx, path))


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Visualization for false prediction (PyTorch port).")
    parser.add_argument("-rp", "--result_path", default="result.csv",
                        type=str)
    parser.add_argument("-dcrf", "--description_file",
                        default="vn_celeb.json", type=str)
    parser.add_argument("-icnt", "--image_container", default="train",
                        type=str)
    parser.add_argument("-ocnt", "--output_container",
                        default="output_vlz", type=str)
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    visualize_false_prediction(args.result_path,
                               read_json(args.description_file),
                               args.image_container, args.output_container)


if __name__ == "__main__":
    main()
