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
  5. optionally the emotion head: the 112 px faces area-resized to
     ``emotion_size``, ImageNet-normalised and through the 2-branch net in
     the compute dtype, softmax and the top ``emotion_topk`` tags. At
     ``emotion_size`` 224 the resize, normalisation and stem are kernel K7;
     at any other size they are the JAX engine's ``area_resize`` and
     ``imagenet_normalize`` in torch and the net's own stem in cuDNN
     (``ResNet2Branch.forward_normalized``), as the JAX engine runs its
     stem kernel at 224 only. The layer1/layer2 tails run in kernel K8 at
     every size (the kernel takes any map size);

and results scatter back to the padded layout. ``identify`` turns the
padded outputs into per-frame names on the host.

With ``mesh=`` (``parallel.make_mesh``, one process a device) the chunk is
sharded over the mesh's data axis, as the JAX engine's jitted chunk is:
every rank is given the whole chunk, pads it with blank frames to a
multiple of ``n_data``, and runs the detector and the rest on its own
contiguous block with the weights replicated from rank 0. Compaction stays
global: the ranks all-gather their (validity, score) keys, each sorts the
chunk's keys once, as one process would, and keeps the selected slots of
its block, so the selection (ties included) and ``face_cap_overflow`` are
the one-process ones on every rank; ``sat_counts`` is the all-reduced
maximum (the cascade's counts are maxima over frames). The outputs are
all-gathered, so every rank returns the whole chunk's, and
``process_adaptive`` retries on every rank together.
"""

import math
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops.image import (
    area_resize,
    fixed_image_standardization,
    imagenet_normalize,
)
from ..ops.similarity import umeyama_similarity
from ..ops.warp import similarity_warp_frames
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import replicate
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
      compute_dtype: dtype of the standardised faces fed to the encoder,
        and the emotion net's compute dtype.
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
        the faces resized to ``emotion_size`` (``target_fs`` must be 112);
        adds ``emotion_idx`` and ``emotion_prob`` [B, K, emotion_topk].
      emotion_size: side of the emotion net's input (224 runs kernel K7).
      emotion_topk: emotion tags kept per face.
      mesh: a ``parallel.Mesh`` to shard each chunk over its data axis
        (the detector must be on the mesh's device); chunks are then
        padded to a multiple of ``n_data`` too.
    """

    def __init__(self, detector, encoder, classifier, target_fs=112,
                 compute_dtype=torch.float32, face_window=224,
                 face_cap=None, face_hint=None, batch_multiple=1,
                 emotion=None, emotion_size=224, emotion_topk=6, mesh=None):
        self.detector = detector
        self.device = detector.device
        self.mesh = mesh
        if mesh is not None:
            dev = torch.device(self.device)
            if dev.type != mesh.device.type or dev.index not in (
                    None, mesh.device.index):
                raise ValueError(f"the detector is on {dev}, the mesh on "
                                 f"{mesh.device}")
            self.device = mesh.device
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
        self.emotion_size = int(emotion_size)
        self.emotion_topk = int(emotion_topk)
        if mesh is not None:
            self.batch_multiple = math.lcm(self.batch_multiple, mesh.n_data)
            nets = [v for v in vars(detector).values()
                    if isinstance(v, nn.Module)]
            for net in nets + [self.encoder, self.classifier, self.emotion]:
                if net is not None:
                    replicate(mesh, net)

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

    def _select(self, valid, score, face_cap):
        """The compacted slots (indices into this process's ``b * k``
        slots) and the overflow: the top ``face_cap`` slots by (validity,
        score), ties to the lower slot, over the whole chunk; under a mesh
        the ranks' keys are gathered and each keeps its block's slots."""
        keys = torch.stack([valid.reshape(-1).to(torch.float32),
                            score.reshape(-1).to(torch.float32)])
        n_local = keys.shape[1]
        mesh = self.mesh
        if mesh is not None:
            keys = all_gather_rows(keys.T.contiguous(), mesh.data_group).T
        selkey = keys[0] * 2.0 + keys[1]
        sel = torch.sort(selkey, descending=True,
                         stable=True).indices[:face_cap]
        overflow = torch.clamp(keys[0].sum().to(torch.int32) - face_cap,
                               min=0)
        if mesh is not None:
            lo = mesh.d * n_local
            sel = sel[(sel >= lo) & (sel < lo + n_local)] - lo
        return sel, overflow

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
        n_data = 1 if self.mesh is None else self.mesh.n_data
        if face_cap is not None and face_cap < b * k * n_data:
            sel, overflow = self._select(valid, score, face_cap)
            n_sel = len(sel)
            # a rank none of whose slots was selected still runs one slot
            # (its outputs are dropped), so every rank's outputs have the
            # same widths
            run_sel = sel if n_sel else sel.new_zeros(1)
            flat_pts = flat_pts[run_sel]
            flat_boxes = flat_boxes[run_sel]
            image_idx = image_idx[run_sel]

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
            logits, _ = self._emotion_logits(faces)
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
                                device=dev).index_copy(0, sel, v[:n_sel])
            out[name] = v.reshape((b, k) + v.shape[1:])
        if self.mesh is not None:
            group = self.mesh.data_group
            out = {name: all_gather_rows(v, group) for name, v in out.items()}
            if sat is not None:
                sat = sat.clone()
                dist.all_reduce(sat, op=dist.ReduceOp.MAX, group=group)
        if sat is not None:
            out["sat_counts"] = sat
        if overflow is not None:
            out["face_cap_overflow"] = overflow
        return out

    def _emotion_logits(self, faces):
        """The emotion net on the 112 px faces: K7's fused resize and stem
        at ``emotion_size`` 224, else the JAX engine's resize,
        normalisation and the net's own stem."""
        size = self.emotion_size
        if size == 224:
            return self.emotion(faces, self.compute_dtype)
        x = imagenet_normalize(area_resize(faces, (size, size)) / 255.0)
        return self.emotion.forward_normalized(x, self.compute_dtype)

    def _as_frames(self, frames_u8):
        """The chunk as a tensor: on the device, or under a mesh where it
        is (``process`` moves this rank's block alone)."""
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        return frames_u8 if self.mesh is not None else frames_u8.to(
            self.device)

    def process(self, frames_u8):
        """frames_u8: numpy array or tensor [B, H, W, 3] uint8 (under a
        mesh, the whole chunk on every rank). Returns a dict of device
        tensors plus the host values ``_face_cap_used`` and
        ``_frame_hw``."""
        frames = self._as_frames(frames_u8)
        b, h, w = frames.shape[:3]
        bp = self._padded_batch(b)
        if bp != b:
            # ragged tail chunk: pad with blank frames, slice back
            pad = torch.zeros((bp - b,) + tuple(frames.shape[1:]),
                              dtype=frames.dtype, device=frames.device)
            frames = torch.cat([frames, pad])
        if self.mesh is not None:
            block = bp // self.mesh.n_data
            frames = frames[self.mesh.d * block:(self.mesh.d + 1) * block]
        cap = self._select_cap(bp * self.detector.out_cap)
        out = self._run(frames.to(self.device), cap)
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

    def observe(self, outputs):
        """Take the chunk's valid-face count as the hint for the next
        chunk's bucket (``identify`` does; under a mesh the ranks that do
        not identify call it, so every rank picks the same bucket)."""
        if self.face_buckets:
            self._face_hint = int(outputs["valid"].sum())

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
        self.observe(outputs)
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
