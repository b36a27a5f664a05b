"""Recognition pipelines: the fused chunk engine (``engine``) and the
per-image recognition library (``recognition``: detect and align single
images, recognise and emotion-tag their faces), with the alignment
templates and warps (``align``)."""

from .align import (
    align_crops,
    align_faces_batch,
    alignment,
    center_point_dict,
)
from .recognition import (
    Classifier,
    EmotionModel,
    Encoder,
    draw_boxes_on_image,
    draw_emotions,
    find_embedding,
    find_emotion,
    get_face_from_boxes,
    identify_person,
    load_model_classify,
    move_landmark_to_box,
    parallel_detect_and_align,
    recognize_celeb,
    recognize_emotion,
    sequential_detect_and_align,
    write_image,
)

__all__ = [
    "center_point_dict",
    "alignment",
    "align_crops",
    "align_faces_batch",
    "load_model_classify",
    "find_embedding",
    "find_emotion",
    "recognize_celeb",
    "recognize_emotion",
    "identify_person",
    "draw_boxes_on_image",
    "draw_emotions",
    "get_face_from_boxes",
    "move_landmark_to_box",
    "sequential_detect_and_align",
    "parallel_detect_and_align",
    "Encoder",
    "Classifier",
    "EmotionModel",
    "write_image",
]
