"""Dataset split CLI, on the port (no pandas: the ``csv`` module).

Counterpart of the repo-root ``split_train_val.py``, with its flags and
files: a ``train.csv`` of (image, label) rows becomes the ``{label:
[images]}`` manifest JSON (``-o``), labels in sorted order and each label's
images in row order; validation (``-v``) holds out the last image of every
identity that has more than one, and train (``-tr``) keeps the rest;
``--remap_key`` also writes each manifest with its labels renumbered
0..N-1 to ``<name>_remap.json``. A column whose every cell reads as an
integer (else as a float) holds numbers, as pandas reads it, so labels
``2`` and ``10`` sort numerically. As in the repo-root CLI, the default
``-d train.csv`` and ``-tr train.json`` both name ``train_remap.json``,
and the train manifest's remap overwrites the describe file's.

  python -m vn_celeb_face_recognition_tpu_torch.cli.split_train_val \\
      -d train.csv -o vn_celeb.json -tr train.json -v val.json --remap_key
"""

import argparse

from ..utils.io import read_csv_columns, read_json, write_json


def create_file_describe_ds(describe_file, output_file):
    columns = read_csv_columns(describe_file)
    groups = {}
    for label, image in zip(columns["label"], columns["image"]):
        groups.setdefault(label, []).append(image)
    by_label = {str(label): groups[label] for label in sorted(groups)}
    write_json(output_file, by_label)
    print("Created {} for describe VN_celeb ...".format(output_file))
    return by_label


def split_train_val(desc_file, output_train, output_val):
    manifest = read_json(desc_file)
    train = {
        key: (images[:-1] if len(images) > 1 else images)
        for key, images in manifest.items()
    }
    val = {
        key: [images[-1]]
        for key, images in manifest.items()
        if len(images) > 1
    }
    write_json(output_train, train)
    write_json(output_val, val)
    return train, val


def remap_sequence_key(manifest):
    return {
        str(new): manifest[old]
        for new, old in enumerate(manifest)
    }


def _remap_name(path):
    return "{}_remap.json".format(path.rsplit(".", 1)[0])


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Split training and validation set for VN celeb "
                    "(PyTorch port)"
    )
    parser.add_argument("-d", "--describe_file", default="train.csv")
    parser.add_argument("-o", "--out_dict_labels",
                        default="vn_celeb.json")
    parser.add_argument("-tr", "--train_file", default="train.json")
    parser.add_argument("-v", "--val_file", default="val.json")
    parser.add_argument("--remap_key", action="store_true")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    labels = create_file_describe_ds(args.describe_file,
                                     args.out_dict_labels)
    train, val = split_train_val(args.out_dict_labels, args.train_file,
                                 args.val_file)
    if args.remap_key:
        write_json(_remap_name(args.describe_file),
                   remap_sequence_key(labels))
        write_json(_remap_name(args.train_file),
                   remap_sequence_key(train))
        write_json(_remap_name(args.val_file), remap_sequence_key(val))
    return labels, train, val


if __name__ == "__main__":
    main()
