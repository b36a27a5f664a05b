"""The port's command-line entry points, with the repo-root CLIs' flags:

  python -m vn_celeb_face_recognition_tpu_torch.cli.demo_image ...
  python -m vn_celeb_face_recognition_tpu_torch.cli.demo_video ...
  python -m vn_celeb_face_recognition_tpu_torch.cli.celeb_statistic ...
  python -m vn_celeb_face_recognition_tpu_torch.cli.find_embedding ...
  python -m vn_celeb_face_recognition_tpu_torch.cli.train -c <config>
  python -m vn_celeb_face_recognition_tpu_torch.cli.eval -c <config>

Each runs on the card unless ``-dv cpu`` (``-d CPU`` for train and eval) is
passed; with no card visible it raises. Images are decoded by ``utils.frames.read_image`` (PNG in Python,
JPEG through the IO runtime) and videos by ``native.loader.VideoReader``;
only the annotated outputs (``demo_image``'s picture, ``-sfr``, ``-ov``)
need cv2.
"""
