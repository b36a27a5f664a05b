"""Fused frame-chunk recognition engine: detect -> align -> embed ->
classify over a [B, H, W, 3] uint8 chunk, on one device, eagerly.

Counterpart of ``vn_celeb_face_recognition_tpu/pipeline/engine.py``
(``FusedRecognitionEngine``):

  1. the detector gives padded boxes, landmarks and validity: the MTCNN
     cascade (stage 1 through kernel K2) or RetinaFace (stage 1 through
     kernel K6);
  2. compaction keeps the top ``face_cap`` slots of the chunk by
     (validity, score);
  3. each face gets a fixed window around its box, a Umeyama solve
     onto the canonical template, and a similarity warp to a
     ``target_fs`` face that samples the window straight from the frames
     (kernel K1; no window stack is cut);
  4. standardisation, the embedding encoder and the MLP give
     log-probabilities, the class and its probability;
  5. optionally the emotion head: the 112 px faces resized to 224,
     ImageNet-normalised and through the 2-branch net (the resize,
     normalisation and stem in kernel K7, the layer1/layer2 tails in
     kernel K8), softmax and the top ``emotion_topk`` tags;

and results scatter back to the padded layout. ``identify`` turns the
padded outputs into per-frame names on the host.
"""

import warnings

import numpy as np
import torch

from ..ops.image import fixed_image_standardization
from ..ops.similarity import umeyama_similarity
from ..ops.warp import similarity_warp_frames
from .align import center_point_dict


class FusedRecognitionEngine:
    """detect + align + embed + classify for fixed-shape frame chunks.

    Args:
      detector: ``models.mtcnn.MTCNN`` or ``models.retinaface.RetinaFace``
        (any object with ``device``, ``out_cap`` and ``detect_padded``
        returning (boxes, scores, points, valid[, sat_counts])); the
        engine runs on its device.
      encoder: embedding ``nn.Module`` taking NCHW standardised faces.
      classifier: ``nn.Module`` mapping embeddings to log-probabilities.
      target_fs: aligned face size.
      compute_dtype: dtype of the standardised faces fed to the encoder.
      face_window: side of the per-face window the warp samples from.
      face_cap: None (no compaction), an int budget, or a list of bucket
        budgets; ``process`` picks the smallest bucket covering the last
        observed valid-face count and ``process_adaptive`` re-runs a
        chunk that overflowed at the next bucket up.
      face_hint: initial expected valid-face count (first bucket).
      batch_multiple: chunks are padded with blank frames up to a
        multiple of this (a ragged tail chunk keeps the shapes of full
        chunks); outputs are sliced back.
      emotion: optional ``models.resnet_2_branch.ResNet2Branch`` run on
        the faces at 224 px (``target_fs`` must be 112); adds
        ``emotion_idx`` and ``emotion_prob`` [B, K, emotion_topk].
      emotion_topk: emotion tags kept per face.
    """

    def __init__(self, detector, encoder, classifier, target_fs=112,
                 compute_dtype=torch.float32, face_window=224,
                 face_cap=None, face_hint=None, batch_multiple=1,
                 emotion=None, emotion_topk=6):
        self.detector = detector
        self.device = detector.device
        self.encoder = encoder.to(self.device).eval()
        self.classifier = classifier.to(self.device).eval()
        self.target_fs = int(target_fs)
        self.template = torch.from_numpy(
            center_point_dict[str((self.target_fs, self.target_fs))]
        ).to(self.device)
        self.compute_dtype = compute_dtype
        self.face_window = int(face_window)
        if face_cap is None:
            self.face_buckets = None
        elif isinstance(face_cap, (list, tuple)):
            self.face_buckets = sorted({int(c) for c in face_cap})
        else:
            self.face_buckets = [int(face_cap)]
        self._face_hint = None if face_hint is None else int(face_hint)
        self.batch_multiple = int(batch_multiple)
        if emotion is not None and self.target_fs != 112:
            raise ValueError("the emotion head takes 112 px faces (resized "
                             f"to 224 inside it), got target_fs "
                             f"{self.target_fs}")
        self.emotion = (None if emotion is None
                        else emotion.to(self.device).eval())
        self.emotion_topk = int(emotion_topk)

    @property
    def face_cap(self):
        return self.face_buckets[-1] if self.face_buckets else None

    def _select_cap(self, total_slots):
        """Smallest bucket covering the current hint (the largest bucket
        when no count was observed yet); None when the bucket would not
        be smaller than the chunk's slot count."""
        if not self.face_buckets:
            return None
        buckets = [min(c, total_slots) for c in self.face_buckets]
        hint = self._face_hint
        if hint is not None:
            for c in sorted(set(buckets)):
                if c >= hint:
                    return c if c < total_slots else None
        c = max(buckets)
        return c if c < total_slots else None

    def _padded_batch(self, b):
        return -(-b // self.batch_multiple) * self.batch_multiple

    @torch.no_grad()
    def _run(self, frames, face_cap):
        det_out = self.detector.detect_padded(frames)
        boxes, score, points, valid = det_out[:4]
        # MTCNN adds its per-stage saturation counts as a 5th output
        sat = det_out[4] if len(det_out) > 4 else None
        b, k = boxes.shape[:2]
        h, w = frames.shape[1:3]
        dev = boxes.device
        flat_pts = points.reshape(b * k, 5, 2)
        flat_boxes = boxes.reshape(b * k, 4)
        image_idx = torch.arange(b, device=dev,
                                 dtype=torch.int32).repeat_interleave(k)
        sel = overflow = None
        if face_cap is not None and face_cap < b * k:
            flat_valid = valid.reshape(b * k)
            selkey = flat_valid.to(torch.float32) * 2.0 + score.reshape(-1)
            sel = torch.sort(selkey, descending=True,
                             stable=True).indices[:face_cap]
            flat_pts = flat_pts[sel]
            flat_boxes = flat_boxes[sel]
            image_idx = image_idx[sel]
            overflow = torch.clamp(
                flat_valid.sum(dtype=torch.int32) - face_cap, min=0)

        # a fixed window around each face; landmarks shift into it
        win = min(self.face_window, h, w)
        cx = (flat_boxes[:, 0] + flat_boxes[:, 2]) * 0.5
        cy = (flat_boxes[:, 1] + flat_boxes[:, 3]) * 0.5
        ox = torch.clamp(torch.round(cx - win / 2), 0, w - win)
        oy = torch.clamp(torch.round(cy - win / 2), 0, h - win)
        oxi = torch.nan_to_num(ox).to(torch.int32)
        oyi = torch.nan_to_num(oy).to(torch.int32)
        local_pts = flat_pts - torch.stack([ox, oy], dim=-1)[:, None, :]
        mats = umeyama_similarity(local_pts, self.template)
        # the warp samples each window straight from the uint8 frames
        faces = similarity_warp_frames(frames, image_idx, oyi, oxi, win,
                                       mats, self.target_fs)

        x = fixed_image_standardization(faces).to(self.compute_dtype)
        emb = self.encoder(x.permute(0, 3, 1, 2)).to(torch.float32)
        logp = self.classifier(emb)
        pred = torch.argmax(logp, dim=-1)
        prob = torch.exp(torch.gather(logp, 1, pred[:, None])[:, 0])
        per_face = {"pred": pred, "prob": prob, "embeddings": emb}
        if self.emotion is not None:
            logits, _ = self.emotion(faces)
            eprob = torch.softmax(logits.to(torch.float32), dim=-1)
            # stable descending sort: ties keep the lower index first,
            # as jax.lax.top_k does (torch.topk leaves them unordered)
            top_p, top_idx = torch.sort(eprob, dim=-1, descending=True,
                                        stable=True)
            per_face["emotion_idx"] = top_idx[:, :self.emotion_topk]
            per_face["emotion_prob"] = top_p[:, :self.emotion_topk]
        out = {"boxes": boxes, "scores": score, "points": points,
               "valid": valid}
        for name, v in per_face.items():
            if sel is not None:
                # scatter compacted results back to the padded layout
                v = torch.zeros((b * k,) + v.shape[1:], dtype=v.dtype,
                                device=dev).index_copy(0, sel, v)
            out[name] = v.reshape((b, k) + v.shape[1:])
        if sat is not None:
            out["sat_counts"] = sat
        if overflow is not None:
            out["face_cap_overflow"] = overflow
        return out

    def _as_frames(self, frames_u8):
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        return frames_u8.to(self.device)

    def process(self, frames_u8):
        """frames_u8: numpy array or tensor [B, H, W, 3] uint8. Returns a
        dict of device tensors plus the host values ``_face_cap_used``
        and ``_frame_hw``."""
        frames = self._as_frames(frames_u8)
        b, h, w = frames.shape[:3]
        bp = self._padded_batch(b)
        if bp != b:
            # ragged tail chunk: pad with blank frames, slice back
            pad = torch.zeros((bp - b,) + tuple(frames.shape[1:]),
                              dtype=frames.dtype, device=frames.device)
            frames = torch.cat([frames, pad])
        cap = self._select_cap(bp * self.detector.out_cap)
        out = self._run(frames, cap)
        if bp != b:
            scalar_keys = ("sat_counts", "face_cap_overflow")
            out = {k: (v if k in scalar_keys else v[:b])
                   for k, v in out.items()}
        out["_face_cap_used"] = cap
        out["_frame_hw"] = (h, w)
        return out

    def process_adaptive(self, frames_u8, max_retries=None):
        """``process`` plus an overflow check (one scalar read) and a
        re-run of the same chunk at the next bucket up, so no valid face
        is dropped while a bigger bucket exists."""
        frames = self._as_frames(frames_u8)
        out = self.process(frames)
        if not self.face_buckets or len(self.face_buckets) < 2:
            return out
        retries = (len(self.face_buckets) if max_retries is None
                   else max_retries)
        for _ in range(retries):
            cap = out.get("_face_cap_used")
            if cap is None or "face_cap_overflow" not in out:
                return out
            overflow = int(out["face_cap_overflow"])
            if overflow == 0:
                return out
            self._face_hint = cap + overflow
            bp = self._padded_batch(frames.shape[0])
            if self._select_cap(bp * self.detector.out_cap) == cap:
                return out  # already at the top usable bucket
            out = self.process(frames)
        return out

    def identify(self, outputs, names, threshold):
        """Host post-pass: padded predictions -> per frame (names, boxes)
        of the valid faces, or (names, boxes, emotion_idx, emotion_prob)
        when the emotion head ran. ``names`` maps label -> name;
        ``threshold`` is a float or a per-class dict keyed by
        ``str(label)``; a face under its threshold, or with an unknown
        label, is "Unknown"."""
        outputs = dict(outputs)
        cap_used = outputs.pop("_face_cap_used", None)
        frame_hw = outputs.pop("_frame_hw", None)
        outs = {k: v.cpu().numpy() for k, v in outputs.items()}
        if "sat_counts" in outs and hasattr(self.detector,
                                            "warn_capacity_saturation"):
            self.detector.warn_capacity_saturation(outs["sat_counts"],
                                                   hw=frame_hw)
        overflow = int(outs.get("face_cap_overflow", 0))
        if self.face_buckets:
            self._face_hint = int(outs["valid"].sum())
        if overflow > 0:
            warnings.warn(
                f"engine face_cap={cap_used or self.face_cap} overflowed "
                f"by {overflow} valid faces this chunk — lowest-score "
                "faces were dropped; raise face_cap or use "
                "process_adaptive() for a re-run at the next bucket.",
                stacklevel=2)
        has_emotion = "emotion_idx" in outs
        results = []
        for i in range(outs["valid"].shape[0]):
            frame_names, frame_boxes = [], []
            emotion_idx, emotion_prob = [], []
            for j in np.nonzero(outs["valid"][i])[0]:
                pred = int(outs["pred"][i][j])
                prob = float(outs["prob"][i][j])
                thr = (threshold[str(pred)] if isinstance(threshold, dict)
                       else threshold)
                frame_names.append("Unknown" if prob < thr
                                   else names.get(pred, "Unknown"))
                frame_boxes.append(outs["boxes"][i][j])
                if has_emotion:
                    emotion_idx.append(outs["emotion_idx"][i][j])
                    emotion_prob.append(outs["emotion_prob"][i][j])
            if has_emotion:
                results.append((frame_names, frame_boxes, emotion_idx,
                                emotion_prob))
            else:
                results.append((frame_names, frame_boxes))
        return results
