"""Inference backends for the pipelines (torch).

A backend turns a batch of decoded frames into fixed-shape face detections +
identity embeddings. :class:`ScrfdArcFaceBackend` is the counterpart of the
JAX package's fused program (I420 wire → BGR → letterbox → SCRFD → 5-pt
align → ArcFace → quality), run as torch ops on the configured device, and
of its combined face+person step with :class:`YoloPersonBackend` (one
upload, one chain of ops, one packed download per batch).
:class:`ClipReidBackend` embeds person crops with the CLIP ViT tower (the
ReID match modes, and the curator's scene features).

Outputs (host numpy, fixed shapes):
  boxes ``[B, F, 4]`` xyxy in *reader frame coords*, kps ``[B, F, 5, 2]``,
  scores ``[B, F]``, mask ``[B, F]`` bool, feats ``[B, F, D]`` L2-normalized,
  quality ``[B, F]`` (Laplacian variance of the aligned chip).
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def pad_batch(frames, batch: int, idxs=None):
    """Stack a partial batch and pad it to the fixed program shape by
    repeating the last frame (and index) with a valid=False tail — the one
    padding contract every pipeline call site shares.

    Returns ``(arr [batch, ...], idxs [batch] | None, valid [batch], n)``.
    """
    n = len(frames)
    arr = np.stack(frames)
    if n < batch:
        arr = np.concatenate([arr, np.repeat(arr[-1:], batch - n, axis=0)],
                             axis=0)
    valid = np.zeros((batch,), bool)
    valid[:n] = True
    out_idxs = None
    if idxs is not None:
        idxs = list(idxs)
        out_idxs = np.asarray(idxs + [idxs[-1]] * (batch - n))
    return arr, out_idxs, valid, n


def extract_single_image(backend, img: np.ndarray, canvas: int = 0):
    """Run a face backend on ONE arbitrary-size image using a fixed
    [1, canvas, canvas, 3] shape, returning detections in original-image
    coordinates. Default canvas = the backend's det_size."""
    import cv2

    canvas = int(canvas or getattr(backend, "det_size", 0) or 640)
    s = min(1.0, canvas / max(img.shape[0], img.shape[1]))
    if s < 1.0:
        img = cv2.resize(img, (int(round(img.shape[1] * s)),
                               int(round(img.shape[0] * s))),
                         interpolation=cv2.INTER_AREA)
    arr = np.zeros((1, canvas, canvas, 3), np.uint8)
    arr[0, :img.shape[0], :img.shape[1]] = img
    out = backend.extract_batch(arr, np.ones(1, bool))
    inv = 1.0 / max(s, 1e-6)
    out["boxes"] = out["boxes"] * inv
    out["kps"] = out["kps"] * inv
    return out


class LazyBackend:
    """Defer backend construction to first use (rescue backends, e.g. the
    face_fullframe_imgsz high-res re-probe, often never trigger)."""

    def __init__(self, factory):
        object.__setattr__(self, "_factory", factory)
        object.__setattr__(self, "_b", None)
        object.__setattr__(self, "_pending", {})

    def _get(self):
        if self._b is None:
            object.__setattr__(self, "_b", self._factory())
            for k, v in self._pending.items():
                setattr(self._b, k, v)
            self._pending.clear()
        return self._b

    def extract_batch(self, *a, **k):
        return self._get().extract_batch(*a, **k)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if self._b is None and name in self._pending:
            return self._pending[name]
        return getattr(self._get(), name)

    def __setattr__(self, name, value):
        # attribute WRITES forward to the real backend too (e.g. the
        # prescan driver sets score_thresh on its backend)
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        elif self._b is not None:
            setattr(self._b, name, value)
        else:
            self._pending[name] = value


def i420_to_bgr(planes_u8: torch.Tensor) -> torch.Tensor:
    """``[B, H*3/2, W]`` uint8 I420 → ``[B, H, W, 3]`` float32 BGR
    (full-range BT.601 with linear chroma upsample, matching
    cv2.COLOR_BGR2YUV_I420)."""
    b, h15, w = planes_u8.shape
    h = (h15 * 2) // 3
    y = planes_u8[:, :h, :].float()
    chroma = planes_u8[:, h:, :].reshape(b, 2, h // 2, w // 2).float()
    chroma = F.interpolate(chroma, size=(h, w), mode="bilinear",
                           align_corners=False) - 128.0
    u, v = chroma[:, 0], chroma[:, 1]
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    bl = y + 1.772 * u
    return torch.clamp(torch.stack([bl, g, r], dim=-1), 0.0, 255.0)


def _random_init(module: torch.nn.Module, seed: int) -> None:
    """Deterministic He-normal init from an explicit generator (the
    ``--*-weights random`` mode; the JAX package draws other numbers)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g)
                        * (2.0 / fan_in) ** 0.5)


class ScrfdArcFaceBackend:
    """SCRFD + ArcFace face pipeline as one chain of torch ops per batch:
    I420 wire → BGR → letterbox → SCRFD → NMS into fixed slots → 5-pt chip
    warp → ArcFace → chip quality → one packed ``[B, F, 17+D]`` array.

    Same constructor and ``extract_batch`` / ``submit_batch`` contract as
    the JAX package's ``ScrfdArcFaceBackend``: a ``YoloConfig`` with a
    5-point keypoint head as ``scrfd_cfg`` selects the YOLOv8-face
    detector, ``use_arcface=False`` embeds the chips with a CLIP tower
    (``clip_face_cfg``, ViT-L-14 unless given; random init unless
    ``clip_face_weights``). An ``.onnx`` path as ``scrfd_weights`` or
    ``arcface_weights`` runs that graph (``models/onnx_zoo``) in the
    compute dtype. Host alignment, which this port does not carry yet,
    raises ``ValueError``.
    """

    def __init__(self, scrfd_cfg=None, arcface_cfg=None, det_size: int = 640,
                 score_thresh: float = 0.5, max_faces: int = 8,
                 flip_tta: bool = False, dtype=None, seed: int = 0,
                 scrfd_weights=None, arcface_weights=None,
                 host_align: bool = False, transfer_format: str = "i420",
                 use_arcface: bool = True, clip_face_cfg=None,
                 clip_face_weights=None, embed_slots: int = 0,
                 device=None):
        from ..models import arcface as AF
        from ..models import clip_vit as CV
        from ..models import scrfd as SD
        from ..models import yolov8 as YV
        from ..models.bridge import (load_arcface, load_clip, load_scrfd,
                                     load_yolov8)
        from ..models.onnx_zoo import (OnnxArcFaceEncoder, OnnxScrfdDetector,
                                       detect_faces_onnx, is_onnx_path)

        scrfd_cfg = scrfd_cfg or SD.SCRFD_2_5G
        arcface_cfg = arcface_cfg or AF.W600K_R50
        if host_align:
            raise ValueError("host_align is not ported to torch yet; the "
                             "fused on-device warp is the default")
        self.device = torch.device(device or "cuda")
        self.dtype = dtype or torch.bfloat16
        self.use_arcface = bool(use_arcface)
        self.embed_slots = int(embed_slots) if embed_slots else 0
        self.det_size = int(det_size)
        self.score_thresh = float(score_thresh)
        self.max_faces = int(max_faces)
        self.embed_dim = arcface_cfg.embed_dim
        self.flip_tta = bool(flip_tta)
        self.host_align = False
        self.transfer_format = transfer_format

        if is_onnx_path(scrfd_weights):
            # checkpoint-exact path: execute the insightface graph itself
            # (the reference loads these same files, face_embedder.py:55-65)
            self.scrfd_model = OnnxScrfdDetector(
                scrfd_weights, det_size=self.det_size,
                max_faces=self.max_faces, dtype=self.dtype,
                device=self.device)
            self._detect = detect_faces_onnx
        else:
            if isinstance(scrfd_cfg, YV.YoloConfig):
                # YOLOv8-face: the same output contract as SCRFD
                YV.check_det_size(scrfd_cfg, self.det_size)
                det, load_det = YV.YoloV8(scrfd_cfg), load_yolov8
                self._detect = YV.detect_faces_yolo
            else:
                SD.check_det_size(scrfd_cfg, self.det_size)
                det, load_det = SD.SCRFD(scrfd_cfg), load_scrfd
                self._detect = SD.detect_faces
            if scrfd_weights is None:
                _random_init(det, seed)
            else:
                load_det(det, scrfd_weights)
            self.scrfd_model = det.eval().to(device=self.device,
                                             dtype=self.dtype)
        self.arcface_model = self.clip_model = None
        if self.use_arcface and is_onnx_path(arcface_weights):
            self.arcface_model = OnnxArcFaceEncoder(
                arcface_weights, flip_tta=self.flip_tta, dtype=self.dtype,
                device=self.device)
            self.embed_dim = self.arcface_model.embed_dim
            self._encode = self.arcface_model
        elif self.use_arcface:
            arc = AF.IResNet(arcface_cfg).eval()
            if arcface_weights is None:
                _random_init(arc, seed + 1)
            else:
                load_arcface(arc, arcface_weights)
            self.arcface_model = arc.to(device=self.device, dtype=self.dtype)
            self._encode = partial(AF.encode_chips, self.arcface_model,
                                   flip_tta=self.flip_tta)
        else:
            # identity embedding by a CLIP image tower when ArcFace is off
            clip_cfg = clip_face_cfg or CV.VIT_L_14
            clip = CV.ClipViT(clip_cfg).eval()
            if clip_face_weights is None:
                CV.random_init(clip, torch.Generator().manual_seed(seed + 1))
            else:
                load_clip(clip, clip_face_weights)
            self.clip_model = clip.to(device=self.device, dtype=self.dtype)
            self.embed_dim = clip_cfg.embed_dim
            self._encode = partial(CV.encode_images, self.clip_model)

    # ---- device program -------------------------------------------------
    def _convert(self, wire: torch.Tensor) -> torch.Tensor:
        """Wire format → device-resident float32 BGR."""
        if self.transfer_format == "i420":
            return i420_to_bgr(wire)
        return wire.float()

    def _fused(self, wire: torch.Tensor) -> torch.Tensor:
        return self._fused_bgr(self._convert(wire))

    @torch.inference_mode()
    def _fused_bgr(self, frames: torch.Tensor) -> torch.Tensor:
        from ..ops.align import align_chips
        from ..ops.preprocess import letterbox_topleft
        from ..ops.quality import chip_quality

        b = frames.shape[0]
        padded, scale = letterbox_topleft(frames, self.det_size)
        scales = torch.full((b,), scale, dtype=torch.float32,
                            device=frames.device)
        det = self._detect(self.scrfd_model, padded, scales,
                           self.score_thresh, self.max_faces)
        mask = det["mask"]
        k = min(self.embed_slots or self.max_faces, self.max_faces)
        chips = align_chips(frames, det["kps"][:, :k], mask[:, :k])
        flat = chips.reshape(b * k, *chips.shape[2:])
        feats = self._encode(flat).reshape(b, k, -1)
        quality = chip_quality(flat).reshape(b, k)
        if k < self.max_faces:
            pad = self.max_faces - k
            feats = F.pad(feats, (0, 0, 0, pad))
            quality = F.pad(quality, (0, pad))
            # non-embedded slots must not claim detections: a mask=True slot
            # with zeroed feats reads as fd=1.0 downstream (NMS packs by
            # score, so the dropped slots are the lowest-score faces)
            mask = mask & (torch.arange(self.max_faces, device=mask.device)
                           < k)[None, :]
        feats = torch.where(mask[..., None], feats, torch.zeros((), device=feats.device))
        quality = torch.where(mask, quality, torch.zeros((), device=quality.device))
        return torch.cat([
            det["boxes"],                                  # 4
            det["kps"].reshape(b, self.max_faces, 10),     # 10
            det["scores"][..., None],                      # 1
            mask.float()[..., None],                       # 1
            quality[..., None],                            # 1
            feats,                                         # D
        ], dim=-1)

    def _unpack(self, packed: np.ndarray, valid) -> Dict[str, np.ndarray]:
        b, f = packed.shape[0], packed.shape[1]
        host = {
            "boxes": packed[..., 0:4],
            "kps": packed[..., 4:14].reshape(b, f, 5, 2),
            "scores": packed[..., 14],
            "mask": packed[..., 15] > 0.5,
            "quality": packed[..., 16],
            "feats": packed[..., 17:],
        }
        host["mask"] = host["mask"] & np.asarray(valid)[:, None]
        return host

    def _prepare_transfer(self, frames: np.ndarray) -> np.ndarray:
        """BGR frames → the configured host→device wire format."""
        if self.transfer_format != "i420":
            return frames
        import cv2

        b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        if h % 2 or w % 2:  # I420 needs even dims
            frames = frames[:, : h - (h % 2), : w - (w % 2)]
            h, w = frames.shape[1], frames.shape[2]
        out = np.empty((b, h * 3 // 2, w), np.uint8)
        for i in range(b):
            out[i] = cv2.cvtColor(frames[i], cv2.COLOR_BGR2YUV_I420)
        return out

    def _upload(self, wire: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(wire))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def submit_batch(self, frames, valid, frame_idxs=None):
        """Enqueue the device work and return a zero-arg callable producing
        the host dict. On CUDA the packed result is copied into pinned host
        memory without blocking; the fetch waits on that copy alone."""
        wire = self._prepare_transfer(np.asarray(frames))
        return self._fetcher(self._fused(self._upload(wire)), valid)

    def _fetcher(self, packed_dev: torch.Tensor, valid):
        valid = np.asarray(valid).copy()
        download = start_download(packed_dev)
        return lambda: self._unpack(download(), valid)

    def extract_batch(self, frames, valid, frame_idxs=None):
        return self.submit_batch(frames, valid, frame_idxs)()

    # ---- shared-upload path (one transfer feeds face + person programs) --
    def upload_shared(self, frames: np.ndarray) -> torch.Tensor:
        """Host frames → device-resident float32 BGR via the wire format;
        the result feeds both :meth:`submit_device` and
        :meth:`YoloPersonBackend.submit_device`."""
        wire = self._prepare_transfer(np.asarray(frames))
        return self._convert(self._upload(wire))

    def submit_device(self, bgr_dev, valid, frame_idxs=None):
        return self._fetcher(self._fused_bgr(bgr_dev), valid)

    # ---- combined face+person step: ONE chain of ops, ONE download ------
    def _combined_with(self, person):
        """The face chain AND the person detector on one device-resident
        BGR batch, everything packed into one ``[B, F·(17+D) + P·6]``
        array."""
        @torch.inference_mode()
        def combo(bgr):
            f = self._fused_bgr(bgr)                  # [B, F, 17+D]
            p = person._fused(bgr, person.conf)       # dict of [B, P, ...]
            b = f.shape[0]
            pp = torch.cat([p["boxes"], p["scores"][..., None],
                            p["mask"].float()[..., None]], dim=-1)
            return torch.cat([f.reshape(b, -1), pp.reshape(b, -1)], dim=1)

        return combo

    def submit_device_with_person(self, person, bgr_dev, valid,
                                  frame_idxs=None):
        """Shared-upload + combined program: returns ONE fetch producing
        ``(face_out, person_out)`` from a single packed download."""
        return self._combo_fetch(self._combined_with(person)(bgr_dev), valid,
                                 person)

    def _combined_wire_with(self, person):
        """The combined program from the WIRE format (uint8 i420/bgr):
        convert → face chain → person detector → packed output."""
        combo = self._combined_with(person)
        return lambda wire: combo(self._convert(wire))

    def submit_wire_with_person(self, person, frames, valid,
                                frame_idxs=None):
        """Host frames → wire format → ONE upload, one chain of ops running
        convert + face + person; returns one fetch producing
        ``(face_out, person_out)`` from a single packed download."""
        wire = self._prepare_transfer(np.asarray(frames))
        packed_dev = self._combined_wire_with(person)(self._upload(wire))
        return self._combo_fetch(packed_dev, valid, person)

    def _combo_fetch(self, packed_dev, valid, person):
        valid = np.asarray(valid).copy()
        face_cols = 17 + self.embed_dim
        face_w = self.max_faces * face_cols
        p_det = int(person.max_det)
        download = start_download(packed_dev)

        def fetch():
            host = download()
            b = host.shape[0]
            face = host[:, :face_w].reshape(b, self.max_faces, face_cols)
            out = self._unpack(face, valid)
            pp = host[:, face_w:].reshape(b, p_det, 6)
            person_out = {
                "boxes": pp[..., :4],
                "scores": pp[..., 4],
                "mask": (pp[..., 5] > 0.5) & valid[:, None],
            }
            return out, person_out

        return fetch


def start_download(out: torch.Tensor):
    """Start the device→host copy of ``out`` and return ``fetch() ->
    np.ndarray``. On CUDA the copy goes into pinned host memory without
    blocking, and the fetch waits on that copy alone."""
    if out.device.type != "cuda":
        return out.numpy
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return fetch


class YoloPersonBackend:
    """YOLOv8 person detection as one chain of torch ops per batch:
    ``[B, H, W, 3]`` uint8 → letterbox → YOLOv8 → DFL decode → per-level
    top-k → NMS into ``max_det`` slots → person boxes/scores/mask in reader
    frame coords, clamped to the frame.

    Same constructor and ``detect_batch`` / ``submit_batch`` /
    ``submit_device`` contract as the JAX package's ``YoloPersonBackend``
    (det size 640 and bf16 unless given); ``_fused(frames_bgr_float, conf)``
    is the program the face backend's combined step runs.
    """

    def __init__(self, cfg=None, det_size: int = 640, conf: float = 0.35,
                 max_det: int = 16, dtype=None, seed: int = 0, weights=None,
                 device=None):
        from ..models import yolov8 as Y
        from ..models.bridge import load_yolov8

        cfg = cfg or Y.YOLOV8N
        Y.check_det_size(cfg, int(det_size))
        self.device = torch.device(device or "cuda")
        self.dtype = dtype or torch.bfloat16
        self.det_size = int(det_size)
        self.conf = float(conf)
        self.max_det = int(max_det)
        model = Y.YoloV8(cfg).eval()
        if weights is None:
            _random_init(model, seed)
        else:
            load_yolov8(model, weights)
        self.model = model.to(device=self.device, dtype=self.dtype)

    @torch.inference_mode()
    def _fused(self, frames: torch.Tensor, conf: float):
        from ..models.yolov8 import detect_persons
        from ..ops.preprocess import letterbox_topleft

        frames = frames.float()
        padded, scale = letterbox_topleft(frames, self.det_size)
        scales = torch.full((frames.shape[0],), scale, dtype=torch.float32,
                            device=frames.device)
        return detect_persons(self.model, padded, scales, conf, self.max_det,
                              clip_hw=tuple(frames.shape[1:3]))

    def detect_batch(self, frames, valid, frame_idxs=None):
        return self.submit_batch(frames, valid, frame_idxs)()

    def submit_batch(self, frames, valid, frame_idxs=None):
        """Enqueue the person program on the raw BGR frames and return a
        fetcher."""
        t = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return self._submit(t, valid)

    def submit_device(self, bgr_dev, valid, frame_idxs=None):
        """Shared-upload variant: consume the device-resident float32 BGR
        of :meth:`ScrfdArcFaceBackend.upload_shared`."""
        return self._submit(bgr_dev, valid)

    def _submit(self, frames_dev, valid):
        out = self._fused(frames_dev, self.conf)
        downloads = {k: start_download(v) for k, v in out.items()}
        valid = np.asarray(valid).copy()

        def fetch():
            host = {k: d() for k, d in downloads.items()}
            host["mask"] = host["mask"] & valid[:, None]
            return host

        return fetch


class ClipReidBackend:
    """CLIP ViT ReID embedding (torch). ``extract(crops)`` resizes each crop
    on the host as the open_clip preprocess does (cv2 bicubic of the
    shortest side to the tower's size, then a centre crop), pads each chunk
    to ``batch`` by repeating its last crop, and returns ``[N, D]`` float32
    L2-normalized embeddings.

    Same constructor and ``extract`` contract as the JAX package's
    ``ClipReidBackend``: ViT-L-14 unless ``cfg`` is given, bf16 unless
    ``dtype`` is given (whatever the run's compute dtype), random init from
    a seeded generator unless ``weights``.
    """

    def __init__(self, cfg=None, batch: int = 16, dtype=None, seed: int = 0,
                 weights=None, device=None):
        from ..models import clip_vit as CV
        from ..models.bridge import load_clip

        cfg = cfg or CV.VIT_L_14
        self.device = torch.device(device or "cuda")
        self.dtype = dtype or torch.bfloat16
        self.batch = int(batch)
        self.embed_dim = cfg.embed_dim
        model = CV.ClipViT(cfg).eval()
        if weights is None:
            CV.random_init(model, torch.Generator().manual_seed(int(seed)))
        else:
            load_clip(model, weights)
        self.model = model.to(device=self.device, dtype=self.dtype)
        self._size = cfg.image_size

    def _preprocess(self, c: np.ndarray) -> np.ndarray:
        import cv2

        s = self._size
        h, w = c.shape[:2]
        if (h, w) == (s, s):
            return c
        scale = s / min(h, w)
        nw, nh = max(s, int(w * scale)), max(s, int(h * scale))
        r = cv2.resize(c, (nw, nh), interpolation=cv2.INTER_CUBIC)
        y0 = int(round((nh - s) / 2.0))
        x0 = int(round((nw - s) / 2.0))
        return r[y0:y0 + s, x0:x0 + s]

    def extract(self, crops) -> np.ndarray:
        """crops: list of HxWx3 BGR arrays → [N, D] float32 normalized."""
        from ..models.clip_vit import encode_images

        if not len(crops):
            return np.zeros((0, self.embed_dim), np.float32)
        resized = [self._preprocess(c) for c in crops]
        out = []
        for i in range(0, len(resized), self.batch):
            chunk = resized[i:i + self.batch]
            n = len(chunk)
            chunk += [chunk[-1]] * (self.batch - n)
            t = torch.from_numpy(np.stack(chunk).astype(np.float32))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            emb = encode_images(self.model, t)
            out.append(start_download(emb)()[:n])
        return np.concatenate(out, 0)
