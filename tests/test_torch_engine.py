"""The slice as a whole: the port's FusedRecognitionEngine on the CPU
against the JAX package on the same frames and weights.

Two references: a composition of JAX package functions that computes the
same chunk step by step (cascade, compaction, window cut, Umeyama, exact
``warp_affine``, standardisation, InceptionResnetV1, MLP), held tightly;
and the JAX ``FusedRecognitionEngine`` with both TPU kernels in
interpret mode, held loosely because its warp is the 3-shear
factorisation.
"""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vn_celeb_face_recognition_tpu.models import mtcnn as JM
from vn_celeb_face_recognition_tpu.models.inception_resnet_v1 import (
    InceptionResnetV1 as JEnc,
)
from vn_celeb_face_recognition_tpu.models.mlp import MLPModel as JMLP
from vn_celeb_face_recognition_tpu.ops.image import (
    fixed_image_standardization,
    warp_affine,
)
from vn_celeb_face_recognition_tpu.ops.similarity import umeyama_similarity
from vn_celeb_face_recognition_tpu.pipeline.align import (
    center_point_dict as j_templates,
)
from vn_celeb_face_recognition_tpu.pipeline.engine import (
    FusedRecognitionEngine as JEngine,
)
from vn_celeb_face_recognition_tpu_torch.models import mtcnn as TM
from vn_celeb_face_recognition_tpu_torch.models.inception_resnet_v1 import (
    InceptionResnetV1 as TEnc,
)
from vn_celeb_face_recognition_tpu_torch.models.mlp import MLPModel as TMLP
from vn_celeb_face_recognition_tpu_torch.pipeline.engine import (
    FusedRecognitionEngine as TEngine,
)
from vn_celeb_face_recognition_tpu_torch.utils import kernels
from vn_celeb_face_recognition_tpu_torch.utils.frames import build_frames

from test_torch_encoder import load_pair
from torch_shared import once_a_run
from torch_shared import two_threads  # noqa: F401 (autouse)

DET = dict(min_face_size=50, pnet_cap_per_scale=128,
           cross_cap=256, rnet_cap=64, onet_cap=32, out_cap=8)
N_CLASSES = 1001
FACE_CAP = 12  # < 2 frames x out_cap 8 slots, so compaction runs


def jax_composition(frames, jdet, enc_vars, clf_vars, face_cap, fs=112,
                    win=224):
    """The engine's chunk computed from JAX package functions alone."""
    b, h, w = frames.shape[:3]
    boxes, score, points, valid, _ = jdet._build_detect_fn(b, h, w)(
        jdet.variables, jnp.asarray(frames))
    k = boxes.shape[1]
    flat_pts = points.reshape(b * k, 5, 2)
    flat_boxes = boxes.reshape(b * k, 4)
    image_idx = jnp.repeat(jnp.arange(b, dtype=jnp.int32), k)
    selkey = valid.reshape(-1).astype(jnp.float32) * 2.0 + score.reshape(-1)
    _, sel = jax.lax.top_k(selkey, face_cap)
    flat_pts, flat_boxes, image_idx = (flat_pts[sel], flat_boxes[sel],
                                       image_idx[sel])
    frames_f = jnp.asarray(frames, jnp.float32)
    win = min(win, h, w)
    cx = (flat_boxes[:, 0] + flat_boxes[:, 2]) * 0.5
    cy = (flat_boxes[:, 1] + flat_boxes[:, 3]) * 0.5
    ox = jnp.clip(jnp.round(cx - win / 2), 0, w - win)
    oy = jnp.clip(jnp.round(cy - win / 2), 0, h - win)
    windows = jax.vmap(lambda i, y, x: jax.lax.dynamic_slice(
        frames_f, (i, y.astype(jnp.int32), x.astype(jnp.int32), 0),
        (1, win, win, 3))[0])(image_idx, oy, ox)
    local_pts = flat_pts - jnp.stack([ox, oy], axis=-1)[:, None, :]
    template = jnp.asarray(j_templates[str((fs, fs))])
    mats = jax.vmap(lambda lm: umeyama_similarity(lm, template))(local_pts)
    faces = jax.vmap(lambda img, m: warp_affine(img, m, (fs, fs)))(
        windows, mats)
    emb = JEnc().apply(enc_vars, fixed_image_standardization(faces))
    logp = JMLP(512, N_CLASSES).apply(clf_vars, emb)
    # scatter back to the padded [B, K] layout
    sel = np.asarray(sel)
    emb_full = np.zeros((b * k, 512), np.float32)
    emb_full[sel] = np.asarray(emb)
    pred_full = np.zeros(b * k, np.int64)
    pred_full[sel] = np.asarray(jnp.argmax(logp, -1))
    return {"valid": np.asarray(valid), "boxes": np.asarray(boxes),
            "embeddings": emb_full.reshape(b, k, 512),
            "pred": pred_full.reshape(b, k)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    frames = build_frames(2, 256, 4, face_px=100)
    enc, enc_vars = load_pair(TEnc(), seed=10)
    clf, clf_vars = load_pair(TMLP(512, N_CLASSES), seed=11)
    jdet = JM.MTCNN(fused_pyramid_pnet=True, **DET)
    # the JAX composition (numpy out) once a run, whichever workers run the
    # module's tests
    ref = once_a_run(tmp_path_factory, "engine_jax_composition", lambda: (
        jax_composition(frames, jdet, enc_vars, clf_vars, FACE_CAP)))

    def engine(face_cap=FACE_CAP, **kw):
        return TEngine(TM.MTCNN(device="cpu", **DET), enc, clf, target_fs=112,
                       face_cap=face_cap, **kw)

    return frames, engine, ref, (jdet, enc_vars, clf_vars)


def _np(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _assert_matches(got, ref):
    v = ref["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    e, r = got["embeddings"][v], ref["embeddings"][v]
    cos = (e * r).sum(-1) / (np.linalg.norm(e, axis=-1)
                             * np.linalg.norm(r, axis=-1))
    assert cos.min() > 0.9999, cos
    np.testing.assert_array_equal(got["pred"][v], ref["pred"][v])


def test_engine_matches_jax_composition(setup):
    frames, engine, ref, _ = setup
    assert ref["valid"].sum() >= 6
    before = kernels.launch_counts()
    got = _np(engine().process(frames))
    # CPU tensors: both kernel wrappers took their plain versions
    assert kernels.launch_counts() == before
    _assert_matches(got, ref)
    assert int(got["face_cap_overflow"]) == 0
    assert got["_face_cap_used"] == FACE_CAP
    assert got["embeddings"].shape == (2, 8, 512)
    assert np.isfinite(got["embeddings"]).all()


def test_engine_matches_jax_engine_with_tpu_kernels(setup, monkeypatch):
    """Against the JAX engine running both Pallas kernels (interpret
    mode): the same detections, embeddings close (3-shear warp)."""
    import vn_celeb_face_recognition_tpu.pipeline.engine as jengine_mod
    from vn_celeb_face_recognition_tpu.ops.warp_pallas import (
        batched_similarity_warp_pallas,
    )

    frames, engine, _, (jdet, enc_vars, clf_vars) = setup
    # the JAX engine calls the warp kernel without the interpret flag
    # (its pyramid PNet kernel selects interpret mode on the CPU itself)
    monkeypatch.setattr(
        jengine_mod, "batched_similarity_warp_pallas",
        functools.partial(batched_similarity_warp_pallas, interpret=True))
    jeng = JEngine(jdet, JEnc(), enc_vars, JMLP(512, N_CLASSES), clf_vars,
                   target_fs=112, use_pallas_warp=True, face_cap=FACE_CAP)
    want = jax.device_get(jeng.process(frames))
    got = _np(engine().process(frames))
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v],
                               rtol=1e-3, atol=1e-2)
    e, r = got["embeddings"][v], want["embeddings"][v]
    cos = (e * r).sum(-1) / (np.linalg.norm(e, axis=-1)
                             * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.98, cos


def test_process_adaptive_buckets_and_identify(setup):
    frames, engine, ref, _ = setup
    nvalid = int(ref["valid"].sum())
    eng = engine(face_cap=[2, FACE_CAP], face_hint=1)
    first = eng.process(frames)
    assert first["_face_cap_used"] == 2
    assert int(first["face_cap_overflow"]) == nvalid - 2
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.identify(first, {}, 0.0)
    assert any("face_cap" in str(w.message) for w in caught)

    eng._face_hint = 1
    out = eng.process_adaptive(frames)
    assert out["_face_cap_used"] == FACE_CAP
    assert int(out["face_cap_overflow"]) == 0
    _assert_matches(_np(out), ref)

    names = {label: f"P{label}" for label in range(N_CLASSES)}
    results = eng.identify(out, names, 0.0)
    assert eng._face_hint == nvalid
    assert len(results) == 2
    for i, (frame_names, frame_boxes) in enumerate(results):
        v = ref["valid"][i]
        assert len(frame_names) == len(frame_boxes) == v.sum()
        assert frame_names == [f"P{p}" for p in ref["pred"][i][v]]
    # per-class thresholds keyed by str(label): 1.1 rejects everything
    thr = {str(label): 1.1 for label in range(N_CLASSES)}
    for frame_names, _ in eng.identify(out, names, thr):
        assert all(n == "Unknown" for n in frame_names)


def test_ragged_tail_chunk_is_padded_and_sliced(setup):
    frames, engine, ref, _ = setup
    got = _np(engine(batch_multiple=4).process(frames))
    assert got["valid"].shape == (2, 8)
    _assert_matches(got, ref)
