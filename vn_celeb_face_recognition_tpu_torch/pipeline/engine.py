"""Fused frame-chunk recognition engine: detect -> align -> embed ->
classify over a [B, H, W, 3] uint8 chunk, on one device, eagerly.

Counterpart of ``vn_celeb_face_recognition_tpu/pipeline/engine.py``
(``FusedRecognitionEngine``):

  1. the MTCNN cascade gives padded boxes, landmarks and validity
     (stage 1 through kernel K2);
  2. compaction keeps the top ``face_cap`` slots of the chunk by
     (validity, score);
  3. each face gets a fixed window cut around its box, a Umeyama solve
     onto the canonical template, and a similarity warp to a
     ``target_fs`` face (kernel K1);
  4. standardisation, the embedding encoder and the MLP give
     log-probabilities, the class and its probability; results scatter
     back to the padded layout.

``identify`` turns the padded outputs into per-frame names on the host.
"""

import warnings

import numpy as np
import torch

from ..ops.image import fixed_image_standardization
from ..ops.similarity import umeyama_similarity
from ..ops.warp import similarity_warp
from .align import center_point_dict


class FusedRecognitionEngine:
    """detect + align + embed + classify for fixed-shape frame chunks.

    Args:
      detector: ``models.mtcnn.MTCNN``; the engine runs on its device.
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
    """

    def __init__(self, detector, encoder, classifier, target_fs=112,
                 compute_dtype=torch.float32, face_window=224,
                 face_cap=None, face_hint=None, batch_multiple=1):
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
        boxes, score, points, valid, sat = self.detector.detect_padded(frames)
        b, k = boxes.shape[:2]
        h, w = frames.shape[1:3]
        dev = boxes.device
        flat_pts = points.reshape(b * k, 5, 2)
        flat_boxes = boxes.reshape(b * k, 4)
        image_idx = torch.arange(b, device=dev).repeat_interleave(k)
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
        oxi = torch.nan_to_num(ox).to(torch.int64)
        oyi = torch.nan_to_num(oy).to(torch.int64)
        ar = torch.arange(win, device=dev)
        windows = frames[image_idx[:, None, None],
                         oyi[:, None, None] + ar[None, :, None],
                         oxi[:, None, None] + ar[None, None, :]]
        windows = windows.to(torch.float32)
        local_pts = flat_pts - torch.stack([ox, oy], dim=-1)[:, None, :]
        mats = umeyama_similarity(local_pts, self.template)
        faces = similarity_warp(windows, mats, self.target_fs)

        x = fixed_image_standardization(faces).to(self.compute_dtype)
        emb = self.encoder(x.permute(0, 3, 1, 2)).to(torch.float32)
        logp = self.classifier(emb)
        pred = torch.argmax(logp, dim=-1)
        prob = torch.exp(torch.gather(logp, 1, pred[:, None])[:, 0])
        if sel is not None:
            # scatter compacted results back to the padded layout
            pred = torch.zeros(b * k, dtype=pred.dtype,
                               device=dev).index_copy(0, sel, pred)
            prob = torch.zeros(b * k, dtype=prob.dtype,
                               device=dev).index_copy(0, sel, prob)
            emb = torch.zeros((b * k, emb.shape[-1]), dtype=emb.dtype,
                              device=dev).index_copy(0, sel, emb)
        out = {
            "boxes": boxes,
            "scores": score,
            "points": points,
            "valid": valid,
            "pred": pred.reshape(b, k),
            "prob": prob.reshape(b, k),
            "embeddings": emb.reshape(b, k, -1),
            "sat_counts": sat,
        }
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
        of the valid faces. ``names`` maps label -> name; ``threshold``
        is a float or a per-class dict keyed by ``str(label)``; a face
        under its threshold, or with an unknown label, is "Unknown"."""
        outputs = dict(outputs)
        cap_used = outputs.pop("_face_cap_used", None)
        frame_hw = outputs.pop("_frame_hw", None)
        outs = {k: v.cpu().numpy() for k, v in outputs.items()}
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
        results = []
        for i in range(outs["valid"].shape[0]):
            frame_names, frame_boxes = [], []
            for j in np.nonzero(outs["valid"][i])[0]:
                pred = int(outs["pred"][i][j])
                prob = float(outs["prob"][i][j])
                thr = (threshold[str(pred)] if isinstance(threshold, dict)
                       else threshold)
                frame_names.append("Unknown" if prob < thr
                                   else names.get(pred, "Unknown"))
                frame_boxes.append(outs["boxes"][i][j])
            results.append((frame_names, frame_boxes))
        return results
