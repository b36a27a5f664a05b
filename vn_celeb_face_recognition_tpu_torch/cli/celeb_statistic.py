"""Celebrity-appearance statistics CLI on the port -> tracker.csv +
tracker.json.

Counterpart of the repo-root ``celeb_statistic.py``, with its flags: the
``demo_video`` frame loop with per-second frame sampling (``-fidx``),
per-class ``--local_thresholds`` (or one global threshold for every class),
``tracker.csv`` reuse when the file exists, and the aggregation of the
tracker rows into interval -> celebrity -> sightings JSON (dynamic or fixed
intervals, at least ``-tap`` sightings). ``--youtube_video`` resolves the
URL with pafy or yt-dlp when one is installed, else exits.

  python -m vn_celeb_face_recognition_tpu_torch.cli.celeb_statistic \\
      -i clip.mp4 -m model_best.pth \\
      -l2n meta_data/face_recognition/label2name_1020_cls.txt -nc 1021 \\
      -det RetinaFace -dargs cfg/detection/retina_face.json \\
      -enc iresnet100 -eargs cfg/embedding/iresnet100_enc.json \\
      --inference_method par_fd_vs_aln --track_bbox --recog_emotion \\
      --local_thresholds meta_data/face_recognition/local_thresholds.json \\
      --statistic_mode dynamic_itv --n_frames 120 -fidx 1 6 11 16

``tracker.csv`` is read back with the ``csv`` module (``TrackerTable``),
as the JAX CLI reads it with pandas: ``Time`` as a float, the list columns
as their strings.
"""

import ast
import csv
import math
import os

from ..parallel.launch import resolve_devices
from ..pipeline import center_point_dict
from ..utils.device import select_device
from ..utils.io import read_json, write_json
from ..utils.misc import convert_sec_to_max_time_quantity
from .demo_image import setup_models
from .demo_video import build_arg_parser as build_video_arg_parser
from .demo_video import process_video


class TrackerTable:
    """The rows of a ``tracker.csv`` (blank lines skipped), by column
    name: ``table["Time"]`` is a list of floats, any other column a list
    of its strings; ``table.rows(start, end)`` is a slice of the rows."""

    def __init__(self, columns, rows):
        self.columns = list(columns)
        self._rows = rows

    @classmethod
    def read(cls, path):
        with open(path, newline="") as fp:
            reader = csv.reader(fp)
            columns = next(reader)
            rows = [r for r in reader if r]
        for i, r in enumerate(rows):
            if len(r) != len(columns):
                raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, "
                                 f"the header {len(columns)}")
        return cls(columns, rows)

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, column):
        i = self.columns.index(column)
        values = [r[i] for r in self._rows]
        return [float(v) for v in values] if column == "Time" else values

    def rows(self, start, end):
        return TrackerTable(self.columns, self._rows[start:end])


# ---------------------------------------------------------------------------
# tracker.json aggregation
# ---------------------------------------------------------------------------


def find_celeb_infor_in_interval(table_for_itv, unknown_name, n_appear):
    """Each known name of the interval's rows seen at least ``n_appear``
    times -> its sightings (time, normalised box, emotion tags); and the
    interval's first and last times."""
    bboxes_dict = {}
    times = table_for_itv["Time"]
    emotions_col = (
        table_for_itv["Emotion"] if "Emotion" in table_for_itv.columns
        else ["[]"] * len(times)
    )
    zip_obj = zip(
        table_for_itv["Names"], table_for_itv["Bboxes"], times, emotions_col,
    )
    for names_str, bboxes_str, time_s, emotions in zip_obj:
        hms_time = convert_sec_to_max_time_quantity(time_s)
        list_names = ast.literal_eval(names_str)
        list_bboxes = ast.literal_eval(bboxes_str)
        list_emotions = ast.literal_eval(emotions)
        if len(list_emotions) < len(list_names):
            list_emotions = [[] for _ in list_names]
        for name, bbox, emotion in zip(list_names, list_bboxes,
                                       list_emotions):
            bbox_item = {
                "time": hms_time,
                "bbox": bbox,
                "emotions": emotion,
            }
            bboxes_dict.setdefault(name, []).append(bbox_item)

    final_bboxes_dict = {
        k: v
        for k, v in bboxes_dict.items()
        if k != unknown_name and len(v) >= n_appear
    }
    start_itv = convert_sec_to_max_time_quantity(times[0])
    end_itv = convert_sec_to_max_time_quantity(times[-1])
    return final_bboxes_dict, start_itv, end_itv


def _export(table, output_js_path, ranges, n_appear, unknown_name):
    dict_track = {}
    for i, (start_range, end_range) in enumerate(ranges):
        final, start_itv, end_itv = find_celeb_infor_in_interval(
            table.rows(start_range, end_range), unknown_name, n_appear
        )
        dict_track[str(i + 1)] = {
            "interval": (start_itv, end_itv),
            "celebrities": final,
        }
    write_json(output_js_path, dict_track, log=True)
    return dict_track


def export_json_stat_dynamic_itv(table, output_js_path, n_intervals,
                                 n_appear=4, unknown_name="Unknown"):
    """``n_intervals`` intervals of equal row counts, the remainder added
    to the last."""
    n_rows = len(table)
    n_rows_in_itv = n_rows // n_intervals
    last = n_intervals - 1
    ranges = [(i * n_rows_in_itv, (i + 1) * n_rows_in_itv
               + (n_rows % n_intervals if i == last else 0))
              for i in range(n_intervals)]
    return _export(table, output_js_path, ranges, n_appear, unknown_name)


def export_json_stat_fixed_itv(table, output_js_path, n_rows_in_itv,
                               n_appear=4, unknown_name="Unknown"):
    """Intervals of ``n_rows_in_itv`` rows, the last one shorter."""
    n_rows = len(table)
    ranges = [(i * n_rows_in_itv, min((i + 1) * n_rows_in_itv, n_rows))
              for i in range(math.ceil(n_rows / n_rows_in_itv))]
    return _export(table, output_js_path, ranges, n_appear, unknown_name)


def resolve_youtube_url(url):
    """A YouTube page URL -> a direct mp4 stream URL, through pafy or
    yt-dlp when one is installed (and the network is reachable); exits
    when neither is installed."""
    try:
        import pafy  # type: ignore

        play = pafy.new(url).getbest(preftype="mp4")
        return None if play is None else play.url
    except ImportError:
        pass
    try:
        import yt_dlp  # type: ignore

        with yt_dlp.YoutubeDL({"format": "mp4"}) as ydl:
            info = ydl.extract_info(url, download=False)
            return info["url"]
    except ImportError:
        raise SystemExit(
            "YouTube ingestion needs pafy or yt-dlp installed."
        )


def build_arg_parser():
    parser = build_video_arg_parser()
    parser.description = "Celebrity statistics on a video (PyTorch port)"
    parser.add_argument("-vp", "--video_path", default=None, type=str)
    parser.add_argument("-jst", "--json_tracker", default="tracker.json",
                        type=str)
    parser.add_argument("-fidx", "--frame_idxes", nargs="+", type=int)
    parser.add_argument("-ign", "--ignored_name", default="Unknown",
                        type=str)
    parser.add_argument("-nvi", "--n_video_intervals", default=5, type=int)
    parser.add_argument("-tap", "--n_time_appear", default=8, type=int)
    parser.add_argument("--statistic_mode", default="dynamic_itv", type=str,
                        help="dynamic_itv or fixed_itv")
    parser.add_argument("--time_an_interval", default=5, type=int)
    parser.add_argument("--local_thresholds", default="", type=str)
    parser.add_argument("--track_bbox", action="store_true")
    parser.add_argument("--youtube_video", action="store_true")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    if args.video_path is None:
        args.video_path = args.image_path

    select_device(args.device)

    if args.local_thresholds != "":
        print("Using local thresholds !")
        threshold = read_json(args.local_thresholds)
    else:
        print("Using global a threshold !")
        threshold = {
            str(i): args.recog_threshold for i in range(args.num_classes)
        }

    if args.youtube_video:
        args.video_path = resolve_youtube_url(args.video_path)

    frame_idxes = list(args.frame_idxes) if args.frame_idxes else None

    if not os.path.exists(args.output_tracker):
        print("Create tracker file {}".format(args.output_tracker))
        sharded = args.fused_engine and resolve_devices(
            args.n_devices, args.device) > 1
        # a sharded run builds its models in each of its processes
        models = None if sharded else setup_models(args)
        target_fs = (args.target_face_size, args.target_face_size)
        center_point = center_point_dict[str(target_fs)]
        process_video(args, models, target_fs, center_point, threshold,
                      frame_idxes, track_bbox=True)
    else:
        print("Re-use tracker file {}".format(args.output_tracker))
    table = TrackerTable.read(args.output_tracker)

    print("Statistic mode: {}".format(args.statistic_mode))
    if args.statistic_mode == "dynamic_itv":
        export_json_stat_dynamic_itv(
            table, args.json_tracker, args.n_video_intervals,
            args.n_time_appear, args.ignored_name,
        )
    elif args.statistic_mode == "fixed_itv":
        n_rows_in_itv = args.time_an_interval * len(frame_idxes or [1]) * 60
        export_json_stat_fixed_itv(
            table, args.json_tracker, n_rows_in_itv,
            args.n_time_appear, args.ignored_name,
        )
    else:
        print(
            "This statistic mode {} is not supported !".format(
                args.statistic_mode
            )
        )


if __name__ == "__main__":
    main()
