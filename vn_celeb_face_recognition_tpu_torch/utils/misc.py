"""Misc host helpers: the time format of ``tracker.json``, the loss-curve
plot and the dataset folder flatteners.

Counterpart of the JAX package's ``utils/misc.py``, with its signatures
and output files. Tables are read and written with the ``csv`` module, not
pandas. ``plot_train_val_loss`` needs matplotlib, as the JAX function
does; it is imported when the function runs, and its absence raises an
``ImportError`` that names it.
"""

import glob
import os
import shutil

from .io import read_csv_columns, save_csv


def convert_sec_to_max_time_quantity(second):
    """Seconds -> ``"{h}h:{m}m:{s:.2f}s"``, the time format of
    ``tracker.json``."""
    h = second // 3600
    remain_time = second % 3600
    m = remain_time // 60
    s = remain_time % 60
    return "{}h:{}m:{:.2f}s".format(h, m, s)


def pyplot():
    """matplotlib's pyplot on the Agg backend; raises ``ImportError``
    naming matplotlib where it cannot be imported."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as exc:
        raise ImportError(f"matplotlib is needed to draw figures and could "
                          f"not be imported ({exc})") from exc

    return plt


def plot_train_val_loss(log_file, out_file):
    """Plot the ``Train_loss`` and ``Validation_loss`` columns of a
    trainer's ``log_loss.txt`` (indexed by ``Epoch``) to ``out_file``."""
    plt = pyplot()
    log = read_csv_columns(log_file)
    missing = {"Epoch", "Train_loss", "Validation_loss"} - set(log)
    if missing:
        raise ValueError(f"{log_file}: no {sorted(missing)} column(s)")
    plt.plot(log["Train_loss"], label="Training loss")
    plt.plot(log["Validation_loss"], label="Validation loss")
    plt.ylabel("Loss")
    plt.xlabel("Epoch")
    plt.legend(loc="upper right")
    plt.savefig(out_file)
    print("Plot train and val loss to {}".format(out_file))


def _flatten_dataset(root_dir, output_dir, label_file, label_offset):
    os.makedirs(output_dir, exist_ok=True)
    label_list = []
    for image_path in glob.glob(root_dir + "/*/*"):
        if not os.path.isfile(image_path):
            continue
        label, image_file = image_path.split("/")[-2:]
        image_name, ext = image_file.split(".")
        new_image_file = "{}_{}.{}".format(label, image_name, ext)
        shutil.copyfile(image_path, os.path.join(output_dir, new_image_file))
        label_list.append((new_image_file, int(label) + label_offset))
    save_csv(label_list, label_file, columns=["image", "label"])
    print("Saved label file {}.".format(label_file))


def convert_ds_folder_2_def_structure(root_dir, output_dir, label_file):
    """Folder-per-class layout (1-based class folders) -> flat files
    ``{label}_{name}.{ext}`` in ``output_dir`` and an ``image,label`` CSV
    of 0-based labels."""
    _flatten_dataset(root_dir, output_dir, label_file, label_offset=-1)


def convert_id_ds_2_def_structure(root_dir, output_dir, label_file):
    """The same flattening of 0-based class folders."""
    _flatten_dataset(root_dir, output_dir, label_file, label_offset=0)
