"""Host-side file helpers of the CLIs: JSON, pickles, tracker rows and the
``label,name`` tables.

Counterpart of ``vn_celeb_face_recognition_tpu/utils/io.py`` (the parts the
CLIs use), with the same signatures and file formats. The name tables are
read with the ``csv`` module, not pandas.
"""

import csv
import json
import pickle


def read_json(filename):
    with open(filename, "r") as fp:
        return json.load(fp)


def write_json(filename, content_dict, log=True):
    with open(filename, "w") as fp:
        json.dump(content_dict, fp, indent=True)
    if log:
        print("Write json file {}".format(filename))


def load_pickle(path):
    """Unpickle ``path``: only for the repo's own meta data files, since
    unpickling runs code."""
    with open(path, "rb") as fp:
        return pickle.load(fp)


def append_log_to_file(file_path, list_items):
    """Append one comma-joined CSV row."""
    with open(file_path, "a") as opened_file:
        opened_file.write(",".join(list_items) + "\n")


def read_label2name(path):
    """A ``label,name`` table (``meta_data/face_recognition/label2name*.txt``)
    -> ``{int label: name}``, the form ``pipeline.identify_person`` takes."""
    with open(path, newline="") as fp:
        reader = csv.DictReader(fp)
        missing = {"label", "name"} - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"{path}: no {sorted(missing)} column(s); "
                             f"header {reader.fieldnames}")
        return {int(row["label"]): row["name"] for row in reader}
