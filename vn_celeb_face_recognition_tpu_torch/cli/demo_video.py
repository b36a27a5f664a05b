"""Streaming video face recognition CLI on the port -> tracker.csv.

Counterpart of the repo-root ``demo_video.py``, with its flags, frame
sampling and ``tracker.csv`` format: read frames into chunks of
``--n_frames``, detect, align, recognise (and emotion-tag) each chunk,
optionally draw and save ``frame_<idx>.png``, append one row per frame
(Time, Names, Frame_idx[, Bboxes][, Emotion]) with the boxes normalised to
[0, 1], report the FPS and a per-stage breakdown, optionally re-mux the
saved frames to MP4 (``-ov``).

  python -m vn_celeb_face_recognition_tpu_torch.cli.demo_video -vp clip.mp4 \\
      -l2n meta_data/face_recognition/label2name.txt -m model_best.pth

Frames are decoded on a reader thread, so the next chunk decodes while
the card works on this one, by the IO runtime (``native.loader.VideoReader``)
where it builds, else by ``cv2.VideoCapture`` (``frame_chunks``), and are
RGB. A chunk runs through the recognition library (K1-K8 by
detector), or with ``--fused_engine`` through ``FusedRecognitionEngine``
(MTCNN only). ``-sfr`` and ``-ov`` need cv2, and so does reading where
the IO runtime does not build.

``--n_devices N`` (with ``--fused_engine``; 0 means every visible card)
shards each chunk over N processes started by ``parallel.launch``, one a
card (NCCL), or gloo processes with ``-dv cpu``: rank 0 reads the video and
broadcasts each chunk, then an end-of-stream message, over the data axis;
every rank runs its block of the chunk through the sharded engine; rank 0
alone identifies, draws and writes ``tracker.csv``.
"""

import contextlib
import functools
import glob
import os
import queue
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..models import coerce_dtype
from ..models.mtcnn import MTCNN
from ..pipeline import (
    center_point_dict,
    draw_boxes_on_image,
    draw_emotions,
    parallel_detect_and_align,
    recognize_celeb,
    recognize_emotion,
    sequential_detect_and_align,
    write_image,
)
from ..parallel import launch, make_mesh
from ..parallel.launch import resolve_devices
from ..pipeline.engine import FusedRecognitionEngine
from ..utils.device import select_device
from ..utils.io import append_log_to_file
from ..utils.misc import convert_sec_to_max_time_quantity
from ..utils.tracing import StageTimer
from .demo_image import build_arg_parser as build_image_arg_parser
from .demo_image import setup_models


def export_video_face_recognition(output_frame_dir, fps, output_path):
    """Re-encode the saved ``frame_<i>.png`` files, in the order of their
    video index, into an MP4 (cv2's writer)."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError("-ov/--output_video writes the MP4 with cv2 "
                          "(opencv-python), which is not installed") from exc

    container_path = Path(output_frame_dir)
    image_files = sorted(
        glob.glob(str(container_path / "frame_*.png")),
        key=lambda p: int(Path(p).stem.split("_")[-1]),
    )
    if not image_files:
        print("No saved frames in {}; nothing to export.".format(
            output_frame_dir))
        return
    first_img = cv2.imread(image_files[0])
    height, width, _ = first_img.shape
    out_writer = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"MP4V"), fps, (width, height)
    )
    for image_file in image_files:
        out_writer.write(cv2.imread(image_file))
    out_writer.release()
    print("Save exported video in {} ...".format(output_path))


def chunk_frames(read_next, fps, n_frames, frame_idxes=None):
    """Yield (frames, infos) chunks of up to ``n_frames`` frames from
    ``read_next()`` (a frame, or None at the end), info = [time in the
    video, 1-based frame count]. With ``frame_idxes``, a frame is kept when
    ``count % fps`` equals one of them (per-second sampling; ``fps`` may be
    a float, as the JAX CLI's modulo takes it)."""
    count = 0
    frames, infos = [], []
    while True:
        frame = read_next()
        if frame is None:
            break
        count += 1
        if frame_idxes is not None:
            if not any(count % fps == idx for idx in frame_idxes):
                continue
        frames.append(frame)
        infos.append([count / fps, count])
        if len(frames) == n_frames:
            yield frames, infos
            frames, infos = [], []
    if frames:
        yield frames, infos


@contextlib.contextmanager
def _runtime_frames(video_path, n_frames):
    """(read_next, fps) over the IO runtime's reader, RGB frames."""
    from ..native.loader import VideoReader

    with VideoReader(video_path) as reader:
        pending = deque()

        def read_next():
            if not pending:
                pending.extend(reader.read(max(n_frames, 8)))
                if not pending:
                    return None
            return pending.popleft()

        yield read_next, reader.fps


@contextlib.contextmanager
def _cv2_frames(video_path, use_native):
    """(read_next, fps) over ``cv2.VideoCapture``, its BGR frames turned
    to RGB; fps from ``CAP_PROP_FPS``, 25 when it is 0."""
    from ..native.loader import cv2_module

    cv2 = cv2_module("video_io", use_native, "video frames")
    cap = cv2.VideoCapture(str(video_path))
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video {video_path}")

        def read_next():
            ok, frame = cap.read()
            return np.ascontiguousarray(frame[..., ::-1]) if ok else None

        yield read_next, cap.get(cv2.CAP_PROP_FPS) or 25.0
    finally:
        cap.release()


def frame_chunks(video_path, n_frames, frame_idxes=None, prefetch=2,
                 use_native=None):
    """``chunk_frames`` over a reader of ``video_path``, run on a reader
    thread ``prefetch`` chunks ahead. The reader is the JAX CLI's choice
    (``native.loader.use_runtime``, printed to stderr): None takes the IO
    runtime when it builds here, else ``cv2.VideoCapture``; True the
    runtime; False cv2. Frames are RGB uint8 [H, W, 3]; the video's own
    fps (25 when it states none) drives the times and the sampling. A
    reader's error, its build error included, is raised here."""
    from ..native.loader import use_runtime

    if use_runtime("video_io", use_native, "video frames"):
        open_frames = functools.partial(_runtime_frames, video_path, n_frames)
    else:
        open_frames = functools.partial(_cv2_frames, video_path, use_native)
    q = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with open_frames() as (read_next, fps):
                for chunk in chunk_frames(read_next, fps, n_frames,
                                          frame_idxes):
                    if not put(("chunk", chunk)):
                        return
        except Exception as exc:  # noqa: BLE001 -- re-raised by the reader
            put(("error", exc))
            return
        put(("done", None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            kind, item = q.get()
            if kind == "done":
                return
            if kind == "error":
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def _face_cap_arg(value):
    """--face_cap: '160' -> 160, '64,128,256' -> [64, 128, 256]."""
    parts = [int(v) for v in str(value).split(",") if v.strip()]
    return parts[0] if len(parts) == 1 else parts


def build_fused_engine(models, target_fs, emotion_topk=6, face_cap=None,
                       compute_dtype=None, n_devices=1, mesh=None):
    """The fused chunk engine over the loaded models (MTCNN only, as the
    JAX CLI's engine), on the detector's device. The emotion model, when
    loaded, runs inside the engine on its 112 px faces. ``mesh`` shards
    each chunk over its data axis; ``n_devices`` other than 1 needs one
    (``process_video`` launches the processes and builds it)."""
    if mesh is None and int(n_devices) != 1:
        raise SystemExit(
            f"--n_devices {n_devices}: the sharded engine runs one process a "
            "device under parallel.launch, with the mesh it builds there "
            "(process_video does both)")
    (_, detection_md, emb_model, classify_model, emt_model, _) = models
    if not isinstance(detection_md, MTCNN):
        raise SystemExit(
            "--fused_engine runs the MTCNN detector only, as the JAX CLI's "
            f"engine does; got {type(detection_md).__name__}. Drop "
            "--fused_engine to run it through the recognition library.")
    return FusedRecognitionEngine(
        detection_md, emb_model.module, classify_model.module,
        target_fs=target_fs[0], face_cap=face_cap,
        compute_dtype=coerce_dtype(compute_dtype),
        emotion=None if emt_model is None else emt_model.module,
        emotion_topk=emotion_topk, mesh=mesh,
    )


def tracker_rows(frames, infos, bth_names, bth_boxes, bth_emotions,
                 track_bbox, with_emotion):
    """The chunk's ``tracker.csv`` lines, as the JAX CLI writes them: the
    list columns quoted, boxes normalised by the frame's width and height,
    emotion tags as plain ``str``."""
    lines = []
    for idx, names in enumerate(bth_names):
        bboxes = bth_boxes[idx]
        row = [
            str(infos[idx][0]),
            '"' + str(list(names)) + '"',
            str(infos[idx][1]),
        ]
        if track_bbox:
            if bboxes is None or len(bboxes) == 0:
                scaled_bboxes = []
            else:
                h, w, _ = frames[idx].shape
                scale = np.array([w, h, w, h])
                scaled_bboxes = [
                    [float(v) for v in (np.asarray(x) / scale)]
                    for x in bboxes
                ]
            row.append('"' + str(scaled_bboxes) + '"')
        if with_emotion:
            emotions = bth_emotions[idx]
            emotions_list = []
            if len(bboxes) > 0:
                for i in range(len(emotions)):
                    emotions_list.append([str(t) for t in emotions[i]])
            row.append('"' + str(emotions_list) + '"')
        lines.append(",".join(row) + "\n")
    return lines


def save_recognized_frames(output_frame, frames, infos, bth_names, bth_boxes,
                           bth_emotions, bth_probs):
    """Draw each RGB frame's boxes, names (and emotion tags) in BGR and
    write it as ``frame_<video index>.png`` (cv2)."""
    for idx, names in enumerate(bth_names):
        img = np.ascontiguousarray(frames[idx][..., ::-1])
        if len(names) > 0:
            img = draw_boxes_on_image(img, bth_boxes[idx], names)
        if bth_emotions is not None:
            draw_emotions(img, bth_boxes[idx], bth_emotions[idx],
                          bth_probs[idx])
        write_image(os.path.join(output_frame,
                                 "frame_{}.png".format(infos[idx][1])), img)


def broadcast_chunks(chunks, mesh):
    """Rank 0's chunks on every rank of the mesh's data axis: yields
    (frames, infos, chunk), where ``chunk`` is the stacked uint8 frames on
    the mesh's device (every rank) and ``frames``/``infos`` are the
    chunk's frames and infos on rank 0 (None elsewhere). Rank 0 sends a
    header (more, B, H, W) then the frames for each chunk, and a header
    with more = 0 at the end, so every rank leaves the loop together."""
    group, dev = mesh.data_group, mesh.device
    main = mesh.rank == 0
    it = iter(chunks) if main else None
    while True:
        head = torch.zeros(4, dtype=torch.int64, device=dev)
        item = next(it, None) if main else None
        if item is not None:
            chunk = torch.from_numpy(np.stack(item[0])).to(dev)
            head[0] = 1
            head[1:] = torch.tensor(chunk.shape[:3])
        dist.broadcast(head, src=0, group=group)
        if not int(head[0]):
            return
        if not main:
            chunk = torch.empty(tuple(head[1:].tolist()) + (3,),
                                dtype=torch.uint8, device=dev)
        dist.broadcast(chunk, src=0, group=group)
        yield (item[0], item[1], chunk) if main else (None, None, chunk)


def video_rank(args, target_fs, center_point, threshold, frame_idxes,
               track_bbox, chunks):
    """One process of a sharded ``process_video``: the data mesh over all
    processes, the models, then the frame loop."""
    mesh = make_mesh(device=args.device)
    models = setup_models(args)
    return process_video(args, models, target_fs, center_point, threshold,
                         frame_idxes, track_bbox, chunks, mesh=mesh)


def process_video(args, models, target_fs, center_point, threshold,
                  frame_idxes=None, track_bbox=True, chunks=None, mesh=None):
    """The shared frame loop of the video and statistic CLIs. ``chunks``
    (an iterable of (frames, infos), as ``chunk_frames`` yields) defaults
    to ``frame_chunks(args.video_path, ...)``. Writes ``args.output_tracker``
    and returns (processed frames, wall seconds).

    ``--n_devices`` other than 1 needs ``--fused_engine``; when it asks for
    more than one process (0: every visible card) and no ``mesh`` is
    given, the loop runs under ``parallel.launch`` (``models`` may then be
    None: each process builds its own with ``setup_models``) and rank 0's
    result is returned."""
    n_devices = int(getattr(args, "n_devices", 1))
    fused = getattr(args, "fused_engine", False)
    if n_devices != 1 and not fused:
        # 0 and > 1 act only through the sharded fused engine
        raise SystemExit("--n_devices requires --fused_engine (the "
                         "per-stage path runs single-device)")
    if mesh is None and n_devices != 1:
        n = resolve_devices(n_devices, args.device)
        if n > 1:
            return launch(video_rank, n, torch.device(args.device).type,
                          args, target_fs, center_point, threshold,
                          frame_idxes, track_bbox,
                          None if chunks is None else list(chunks))
    (label2name, detection_md, emb_model, classify_model, emt_model,
     idx2etag) = models
    main = mesh is None or mesh.rank == 0

    engine = None
    if fused:
        engine = build_fused_engine(
            models, target_fs, args.topk_emotions,
            face_cap=getattr(args, "face_cap", None),
            compute_dtype=getattr(args, "compute_dtype", None),
            mesh=mesh,
        )

    if main and not os.path.exists(args.output_frame):
        os.makedirs(args.output_frame)

    box_requirements = None
    if args.inference_method == "seq_fd_vs_aln":
        box_requirements = {
            "min_dim": args.min_dim_box,
            "box_ratio": args.box_ratio,
        }
    elif args.inference_method != "par_fd_vs_aln":
        raise SystemExit(
            "Do not support {} method.".format(args.inference_method))

    df_columns = ["Time", "Names", "Frame_idx"]
    if track_bbox:
        df_columns.append("Bboxes")
    if args.recog_emotion:
        df_columns.append("Emotion")
    if main:
        with open(args.output_tracker, "w") as tracker_file:
            tracker_file.write("")
        append_log_to_file(args.output_tracker, df_columns)

    if chunks is None and main:
        chunks = frame_chunks(args.video_path, args.n_frames, frame_idxes)
    if mesh is None:
        stream = ((f, i, None) for f, i in chunks)
    else:
        stream = broadcast_chunks(chunks, mesh)
    map_func = (np.vectorize(lambda x: idx2etag[x]) if args.recog_emotion
                else None)
    processed_frame = 0
    timer = StageTimer()
    start_time = time.time()
    for frames_queue, frames_info, chunk in stream:
        if not main:
            engine.observe(engine.process_adaptive(chunk))
            continue
        processed_frame += len(frames_queue)
        if processed_frame % args.log_step == 0:
            hms = convert_sec_to_max_time_quantity(frames_info[-1][0])
            print(
                "Processing for frame: {}, time: {}".format(
                    frames_info[-1][1], hms
                )
            )

        bth_emotions = bth_emotion_probs = None
        if engine is not None:
            with timer.stage("fused_engine"):
                outputs = engine.process_adaptive(
                    np.stack(frames_queue) if chunk is None else chunk)
                results = engine.identify(outputs, label2name, threshold)
            bth_names = [r[0] for r in results]
            bth_chosen_boxes = [r[1] for r in results]
            if args.recog_emotion:
                bth_emotions = [
                    map_func(np.asarray(r[2])) if len(r[2]) else []
                    for r in results
                ]
                bth_emotion_probs = [r[3] for r in results]
        else:
            with timer.stage("detect_align"):
                if box_requirements is not None:
                    bth_alg_faces, bth_chosen_boxes = \
                        sequential_detect_and_align(
                            frames_queue, detection_md, center_point,
                            target_fs, box_requirements, False,
                        )
                else:
                    bth_alg_faces, bth_chosen_boxes = \
                        parallel_detect_and_align(
                            frames_queue, detection_md, center_point,
                            target_fs, False,
                        )
            with timer.stage("embed_classify"):
                bth_names = recognize_celeb(
                    bth_alg_faces, None, emb_model, classify_model, None,
                    label2name, threshold,
                )
            if args.recog_emotion:
                with timer.stage("emotion"):
                    bth_emotions, bth_emotion_probs = recognize_emotion(
                        bth_alg_faces, None, emt_model, None, map_func,
                        args.topk_emotions,
                    )

        if getattr(args, "save_frame_recognized", False):
            with timer.stage("draw_save"):
                save_recognized_frames(args.output_frame, frames_queue,
                                       frames_info, bth_names,
                                       bth_chosen_boxes, bth_emotions,
                                       bth_emotion_probs)

        logged_rows = tracker_rows(frames_queue, frames_info, bth_names,
                                   bth_chosen_boxes, bth_emotions,
                                   track_bbox, args.recog_emotion)
        with open(args.output_tracker, "a") as tracker_file:
            tracker_file.write("".join(logged_rows))

    wall = time.time() - start_time
    if not main:
        return processed_frame, wall
    print("Saved tracker file in {} ...".format(args.output_tracker))
    print(
        "FPS for recognition face: {}".format(int(processed_frame / wall))
    )
    print("Per-stage breakdown:")
    timer.log()
    return processed_frame, wall


def build_arg_parser():
    p = build_image_arg_parser()
    p.description = "Face recognition on a video (PyTorch port)"
    p.add_argument("-ot", "--output_tracker", default="tracker.csv",
                   type=str)
    p.add_argument("-ov", "--output_video", default="", type=str)
    p.add_argument("-fps", "--fps_video", default=25.0, type=float)
    p.add_argument("-sfr", "--save_frame_recognized", action="store_true")
    p.add_argument("--log_step", default=100, type=int)
    p.add_argument("--n_frames", default=16, type=int)
    p.add_argument("--fused_engine", action="store_true",
                   help="run detect+align+embed+classify per frame chunk "
                        "through FusedRecognitionEngine (MTCNN only)")
    p.add_argument("--compute_dtype", default=None, type=str,
                   help="fused-engine dtype of the faces fed to the encoder "
                        "(e.g. bfloat16). Detector/encoder dtypes come from "
                        "-dargs/-eargs JSON ('dtype': 'bfloat16').")
    p.add_argument("--face_cap", default=None, type=_face_cap_arg,
                   help="face budget per chunk for the fused engine "
                        "(compaction). One int, or a comma-separated bucket "
                        "list ('64,128,256'): the engine picks the smallest "
                        "bucket covering the last chunk's face count and "
                        "re-runs at the next bucket on overflow")
    p.add_argument("--n_devices", default=1, type=int,
                   help="shard each fused-engine chunk over N processes, "
                        "one a card (0 = every visible card; requires "
                        "--fused_engine); with -dv cpu, N gloo processes")
    p.add_argument("-of", "--output_frame", default="output_frame",
                   type=str)
    return p


def main(argv=None):
    parser = build_arg_parser()
    parser.add_argument("-vp", "--video_path", default=None, type=str)
    args = parser.parse_args(argv)
    if args.video_path is None:
        args.video_path = args.image_path  # -i works like the reference

    select_device(args.device)
    sharded = args.fused_engine and resolve_devices(
        args.n_devices, args.device) > 1
    # a sharded run builds its models in each of its processes
    models = None if sharded else setup_models(args)
    target_fs = (args.target_face_size, args.target_face_size)
    center_point = center_point_dict[str(target_fs)]
    process_video(args, models, target_fs, center_point,
                  args.recog_threshold)
    if args.output_video != "":
        export_video_face_recognition(
            args.output_frame, args.fps_video, args.output_video
        )


if __name__ == "__main__":
    main()
