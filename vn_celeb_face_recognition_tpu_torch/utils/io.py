"""Host-side file helpers of the CLIs and the trainers: JSON, pickles,
folders, tracker rows, ``result.csv`` and the ``label,name`` tables.

Counterpart of ``vn_celeb_face_recognition_tpu/utils/io.py``, with the same
signatures and file formats (``save_pandas_df`` is ``save_csv`` here, and
``read_image`` is ``utils.frames.read_image``). Tables
are read and written with the ``csv`` module, not pandas.
"""

import csv
import json
import os
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


def save_pickle(path, obj):
    with open(path, "wb") as fp:
        pickle.dump(obj, fp)


def create_folder(path):
    os.makedirs(str(path), exist_ok=True)


def save_csv(data, filename, columns):
    """Write ``data`` (an iterable of rows) under a ``columns`` header, as
    ``pandas.DataFrame(data, columns=columns).to_csv(filename,
    index=False)`` does for rows of strings and numbers."""
    with open(filename, "w", newline="") as fp:
        writer = csv.writer(fp, lineterminator="\n")
        writer.writerow(columns)
        for row in data:
            if len(row) != len(columns):
                raise ValueError(f"row {row!r} has {len(row)} fields, "
                                 f"want {len(columns)}")
            writer.writerow([_csv_field(v) for v in row])


def _csv_field(value):
    if hasattr(value, "item"):  # numpy scalars
        value = value.item()
    return repr(value) if isinstance(value, float) else value


def typed_column(cells):
    """A CSV column's cells as pandas types them: all integers, else all
    floats, else strings."""
    for kind in (int, float):
        try:
            return [kind(c) for c in cells]
        except ValueError:
            pass
    return list(cells)


def read_csv_columns(path):
    """A CSV file with a header row -> ``{column: cells}`` in the header's
    order, each column typed by ``typed_column`` (blank lines skipped)."""
    with open(path, newline="") as fp:
        header, *rows = [r for r in csv.reader(fp) if r]
    return {name: typed_column([r[i] for r in rows])
            for i, name in enumerate(header)}


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
