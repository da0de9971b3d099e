"""Inference backends for the pipelines (torch).

A backend turns a batch of decoded frames into fixed-shape face detections +
identity embeddings. :class:`ScrfdArcFaceBackend` is the counterpart of the
JAX package's fused program (I420 wire → BGR → letterbox → SCRFD → 5-pt
align → ArcFace → quality), run as torch ops on the configured device, and
of its combined face+person step with :class:`YoloPersonBackend` (one
upload, one chain of ops, one packed download per batch).
:class:`ClipReidBackend` embeds person crops with the CLIP ViT tower (the
ReID match modes, and the curator's scene features).
:class:`ShardedScrfdArcFaceBackend` runs the face chain over a device mesh
(parallel/mesh.py), across processes too (parallel/multihost.py).

Outputs (host numpy, fixed shapes):
  boxes ``[B, F, 4]`` xyxy in *reader frame coords*, kps ``[B, F, 5, 2]``,
  scores ``[B, F]``, mask ``[B, F]`` bool, feats ``[B, F, D]`` L2-normalized,
  quality ``[B, F]`` (Laplacian variance of the aligned chip).

:class:`OracleBackend` and :class:`OraclePersonBackend` are the JAX
package's numpy test oracles (ground truth of a synthetic video), copied.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import NULL_TIMER


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


def embed_bucket(n: int, total: int) -> int:
    """Rows of the tower batch that carries ``n`` kept chips of a call's
    ``total`` slots: the smallest power of two ≥ ``n``, at least 8 and at
    most ``total``. So the tower sees a few fixed sizes, each of which
    cuDNN and cuBLAS plan once, and never more than twice the kept chips
    (or 8)."""
    return min(int(total), max(8, 1 << (int(n) - 1).bit_length()))


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
    ``--*-weights random`` mode; the JAX package draws other numbers).
    Conv and dense biases are redrawn from the same generator (torch's
    own default draws from the global one), so every process of a
    multi-process run builds the same weights."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g)
                        * (2.0 / fan_in) ** 0.5)
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and \
                    m.bias is not None:
                bound = m.weight[0].numel() ** -0.5
                m.bias.uniform_(-bound, bound, generator=g)


class ScrfdArcFaceBackend:
    """SCRFD + ArcFace face pipeline as one chain of torch ops per batch:
    I420 wire → BGR → letterbox → SCRFD → NMS into fixed slots → 5-pt chip
    warp → ArcFace → chip quality → one packed ``[B, F, 17+D]`` array.

    Same constructor and ``extract_batch`` / ``submit_batch`` contract as
    the JAX package's ``ScrfdArcFaceBackend``: a ``YoloConfig`` with a
    5-point keypoint head as ``scrfd_cfg`` selects the YOLOv8-face
    detector, ``use_arcface=False`` embeds the chips with a CLIP-style
    image tower (``clip_face_cfg``: a ``ClipVitConfig``, ViT-L-14 unless
    given, or a ``SiglipConfig``; random init unless ``clip_face_weights``,
    a flax tree in the tower's layout). An ``.onnx`` path as ``scrfd_weights`` or
    ``arcface_weights`` runs that graph (``models/onnx_zoo``) in the
    compute dtype. ``host_align=True`` splits the chain into detect on the
    device, a cv2 similarity warp of each face on the host
    (:meth:`_align_host`) and embed on the device, as the JAX backend's
    host-align mode does.

    ``timer`` (a ``utils.timing.StepTimer``, the engine's for the length of
    a run) names the stages of each call: ``face.upload``, ``face.convert``,
    ``face.detect`` (inside it ``face.nms``), ``face.align`` and
    ``face.embed`` (inside it ``face.encode``, and inside that a CLIP-style
    tower's ``face.attn``, each attention call), and counts
    ``embed.slots`` (the slots a call offers the embedder),
    ``embed.chips`` (chips through the tower: the kept slots of valid frames
    padded to :func:`embed_bucket` rows, at dispatch),
    ``embed.calls_skipped`` (calls that kept no slot and so made no tower
    call) and ``embed.chips_kept`` (slots the detector kept on valid frames,
    from the fetched host mask).
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
        from ..models import siglip as SG
        from ..models import yolov8 as YV
        from ..models.bridge import (load_arcface, load_clip, load_scrfd,
                                     load_siglip, load_yolov8)
        from ..models.onnx_zoo import (OnnxArcFaceEncoder, OnnxScrfdDetector,
                                       detect_faces_onnx, is_onnx_path)

        scrfd_cfg = scrfd_cfg or SD.SCRFD_2_5G
        arcface_cfg = arcface_cfg or AF.W600K_R50
        self.device = torch.device(device or "cuda")
        self.dtype = dtype or torch.bfloat16
        self.use_arcface = bool(use_arcface)
        self.embed_slots = int(embed_slots) if embed_slots else 0
        self.det_size = int(det_size)
        self.score_thresh = float(score_thresh)
        self.max_faces = int(max_faces)
        self.embed_dim = arcface_cfg.embed_dim
        self.flip_tta = bool(flip_tta)
        self.host_align = bool(host_align)
        self.transfer_format = transfer_format
        self.timer = NULL_TIMER

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
            self._embedder = self.arcface_model
        elif self.use_arcface:
            arc = AF.IResNet(arcface_cfg).eval()
            if arcface_weights is None:
                _random_init(arc, seed + 1)
            else:
                load_arcface(arc, arcface_weights)
            self.arcface_model = arc.to(device=self.device, dtype=self.dtype)
            self._embedder = partial(AF.encode_chips, self.arcface_model,
                                     flip_tta=self.flip_tta)
        else:
            # identity embedding by a CLIP-style image tower when ArcFace
            # is off
            clip_cfg = clip_face_cfg or CV.VIT_L_14
            tower, init, load = ((SG.SiglipViT, SG.random_init, load_siglip)
                                 if isinstance(clip_cfg, SG.SiglipConfig)
                                 else (CV.ClipViT, CV.random_init, load_clip))
            clip = tower(clip_cfg).eval()
            if clip_face_weights is None:
                init(clip, torch.Generator().manual_seed(seed + 1))
            else:
                load(clip, clip_face_weights)
            self.clip_model = clip.to(device=self.device, dtype=self.dtype)
            self.embed_dim = clip_cfg.embed_dim
            self._embedder = self._encode_tower

    # ---- device program -------------------------------------------------
    def _encode_tower(self, chips: torch.Tensor) -> torch.Tensor:
        from ..models.clip_vit import encode_images

        return encode_images(self.clip_model, chips, timer=self.timer)

    def _encode(self, chips: torch.Tensor) -> torch.Tensor:
        """The embedder on ``[N, 112, 112, 3]`` chips → ``[N, D]``: every
        tower call goes through here (a caller may wrap it), and it is the
        ``face.encode`` span, innermost of ``face.embed``."""
        with self.timer("face.encode"):
            return self._embedder(chips)

    def _convert(self, wire: torch.Tensor) -> torch.Tensor:
        """Wire format → device-resident float32 BGR."""
        with self.timer("face.convert"):
            if self.transfer_format == "i420":
                return i420_to_bgr(wire)
            return wire.float()

    def _fused(self, wire: torch.Tensor, valid) -> torch.Tensor:
        return self._fused_bgr(self._convert(wire), valid)

    @torch.inference_mode()
    def _detect_bgr(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detect only: float32 BGR ``[B, H, W, 3]`` on the device →
        letterbox → detector → NMS slots (frame coordinates)."""
        from ..ops.preprocess import letterbox_topleft

        with self.timer("face.detect"):
            padded, scale = letterbox_topleft(frames, self.det_size)
            scales = torch.full((frames.shape[0],), scale,
                                dtype=torch.float32, device=frames.device)
            return self._detect(self.scrfd_model, padded, scales,
                                self.score_thresh, self.max_faces,
                                timer=self.timer)

    @torch.inference_mode()
    def _embed(self, chips: torch.Tensor, kept: torch.Tensor):
        """Embed only the kept chips: ``[N, 112, 112, 3]`` chips and the
        indices ``kept [n]`` of the kept rows on the device → (feats ``[N,
        D]``, quality ``[N]``), zero in every other row. The kept chips are
        gathered into the first rows of a zero batch of
        :func:`embed_bucket` rows, embedded in one tower call and scattered
        back; with none kept there is no call."""
        from ..ops.quality import chip_quality

        total, n = chips.shape[0], kept.shape[0]
        self.timer.count("embed.slots", total)
        feats = torch.zeros((total, self.embed_dim), device=chips.device)
        quality = torch.zeros((total,), device=chips.device)
        if n == 0:
            self.timer.count("embed.calls_skipped", 1)
            return feats, quality
        rows = embed_bucket(n, total)
        self.timer.count("embed.chips", rows)
        with self.timer("face.embed"):
            gathered = chips.new_zeros((rows, *chips.shape[1:]))
            gathered[:n] = chips[kept]
            feats[kept] = self._encode(gathered)[:n]
            quality[kept] = chip_quality(gathered[:n])
        return feats, quality

    @torch.inference_mode()
    def _fused_bgr(self, frames: torch.Tensor, valid=None) -> torch.Tensor:
        """The face chain on float32 BGR ``[B, H, W, 3]`` on the device →
        packed ``[B, F, 17+D]``. ``valid [B]`` (host bool, ``None``: every
        frame) marks the frames whose slots are embedded: the slots of the
        others carry zero features and quality."""
        from ..ops.align import align_chips

        b = frames.shape[0]
        det = self._detect_bgr(frames)
        mask = det["mask"]
        k = min(self.embed_slots or self.max_faces, self.max_faces)
        keep = mask[:, :k]
        if valid is not None:
            keep = keep & self._upload(np.asarray(valid, bool))[:, None]
        # the kept count is read here, before the chips are aligned, so the
        # read waits on the detector alone (its NMS already read the device)
        kept = torch.nonzero(keep.reshape(-1)).squeeze(1)
        with self.timer("face.align"):
            chips = align_chips(frames, det["kps"][:, :k], mask[:, :k])
        feats, quality = self._embed(
            chips.reshape(b * k, *chips.shape[2:]), kept)
        feats = feats.reshape(b, k, -1)
        quality = quality.reshape(b, k)
        if k < self.max_faces:
            pad = self.max_faces - k
            feats = F.pad(feats, (0, 0, 0, pad))
            quality = F.pad(quality, (0, pad))
            # non-embedded slots must not claim detections: a mask=True slot
            # with zeroed feats reads as fd=1.0 downstream (NMS packs by
            # score, so the dropped slots are the lowest-score faces)
            mask = mask & (torch.arange(self.max_faces, device=mask.device)
                           < k)[None, :]
        return torch.cat([
            det["boxes"],                                  # 4
            det["kps"].reshape(b, self.max_faces, 10),     # 10
            det["scores"][..., None],                      # 1
            mask.float()[..., None],                       # 1
            quality[..., None],                            # 1
            feats,                                         # D
        ], dim=-1)

    def _unpack(self, packed: np.ndarray, valid) -> Dict[str, np.ndarray]:
        host = unpack_faces(packed)
        host["mask"] = host["mask"] & np.asarray(valid)[:, None]
        self.timer.count("embed.chips_kept", host["mask"].sum())
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

    def _send(self, frames) -> torch.Tensor:
        """Host BGR frames → the wire format on the device."""
        with self.timer("face.upload"):
            return self._upload(self._prepare_transfer(np.asarray(frames)))

    def submit_batch(self, frames, valid, frame_idxs=None):
        """Enqueue the device work and return a zero-arg callable producing
        the host dict. On CUDA the packed result is copied into pinned host
        memory without blocking; the fetch waits on that copy alone. With
        ``host_align`` the batch runs synchronously and the callable
        returns its result."""
        if self.host_align:
            out = self._extract_host_align(frames, valid)
            return lambda: out
        return self._fetcher(self._fused(self._send(frames), valid), valid)

    def _align_host(self, frames, kps, mask):
        """cv2 similarity warp of every valid face (reference:
        face_embedder.py:1465-1473 semantics: umeyama ≙ LMEDS on clean
        points, INTER_LINEAR, reflect border)."""
        import cv2

        from ..ops.align import ARC_DST, umeyama_similarity

        b, f = mask.shape
        chips = np.zeros((b * f, 112, 112, 3), np.float32)
        for i in range(b):
            frame = frames[i].astype(np.float32)
            for j in np.flatnonzero(mask[i]):
                m = umeyama_similarity(torch.from_numpy(kps[i, j]),
                                       ARC_DST).numpy()
                chips[i * f + j] = cv2.warpAffine(
                    frame, m, (112, 112), flags=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_REFLECT)
        return chips

    def _extract_host_align(self, frames, valid):
        """Detect on the device (the BGR frames as they are, no wire
        format), align on the host, embed the kept slots on the device."""
        frames = np.asarray(frames)
        det = self._detect_bgr(self._upload(frames).float())
        host = {k: start_download(v)() for k, v in det.items()}
        host["mask"] = host["mask"] & np.asarray(valid)[:, None]
        self.timer.count("embed.chips_kept", host["mask"].sum())
        b, f = host["mask"].shape
        with self.timer("face.align"):
            chips = self._align_host(frames, host["kps"], host["mask"])
        kept = self._upload(np.flatnonzero(host["mask"].reshape(-1)))
        feats, quality = self._embed(self._upload(chips), kept)
        host["feats"] = start_download(feats)().reshape(b, f, -1)
        host["quality"] = start_download(quality)().reshape(b, f)
        return host

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
        return self._convert(self._send(frames))

    def submit_device(self, bgr_dev, valid, frame_idxs=None):
        return self._fetcher(self._fused_bgr(bgr_dev, valid), valid)

    # ---- combined face+person step: ONE chain of ops, ONE download ------
    def _combined_with(self, person):
        """The face chain AND the person detector on one device-resident
        BGR batch, everything packed into one ``[B, F·(17+D) + P·6]``
        array. ``valid`` as :meth:`_fused_bgr` takes it."""
        @torch.inference_mode()
        def combo(bgr, valid):
            f = self._fused_bgr(bgr, valid)           # [B, F, 17+D]
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
        return self._combo_fetch(self._combined_with(person)(bgr_dev, valid),
                                 valid, person)

    def _combined_wire_with(self, person):
        """The combined program from the WIRE format (uint8 i420/bgr):
        convert → face chain → person detector → packed output."""
        combo = self._combined_with(person)
        return lambda wire, valid: combo(self._convert(wire), valid)

    def submit_wire_with_person(self, person, frames, valid,
                                frame_idxs=None):
        """Host frames → wire format → ONE upload, one chain of ops running
        convert + face + person; returns one fetch producing
        ``(face_out, person_out)`` from a single packed download."""
        packed_dev = self._combined_wire_with(person)(self._send(frames),
                                                      valid)
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


def unpack_faces(packed):
    """The face chain's packed ``[B, F, 17+D]`` output (host array or
    tensor) → its named fields."""
    b, f = packed.shape[0], packed.shape[1]
    return {
        "boxes": packed[..., 0:4],
        "kps": packed[..., 4:14].reshape(b, f, 5, 2),
        "scores": packed[..., 14],
        "mask": packed[..., 15] > 0.5,
        "quality": packed[..., 16],
        "feats": packed[..., 17:],
    }


def start_download(out: torch.Tensor):
    """Start the device→host copy of ``out`` and return ``fetch() ->
    np.ndarray``. On CUDA the copy goes into pinned host memory without
    blocking, and the fetch waits on that copy alone."""
    if out.device.type != "cuda":
        return out.numpy
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))

    def fetch() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return fetch


class ShardedScrfdArcFaceBackend:
    """Multi-device variant of :class:`ScrfdArcFaceBackend`.

    The frame batch splits over the mesh's ``data`` axis, one
    :class:`ScrfdArcFaceBackend` per data-axis device with the same
    detector, embedder and settings (``use_arcface``, ``clip_face_cfg``,
    ``embed_slots``), and wide layers over the optional ``model`` axis
    (parallel/mesh.py); across processes each computes its own rows and
    every process gets the whole result (parallel/multihost.py). The frames
    go up as BGR, as in the JAX package's sharded step. Exposes the
    extract_batch/submit_batch protocol and, like the JAX backend, no
    shared-upload or combined face+person entry: the main pass calls the
    person detector on its own.
    """

    def __init__(self, mesh=None, mesh_spec: str = "", scrfd_cfg=None,
                 arcface_cfg=None, det_size: int = 640,
                 score_thresh: float = 0.5, max_faces: int = 8,
                 dtype=None, seed: int = 0,
                 scrfd_weights=None, arcface_weights=None,
                 use_arcface: bool = True, clip_face_cfg=None,
                 embed_slots: int = 0, device=None):
        from ..parallel.mesh import build_sharded_prescan_step, make_mesh

        self.mesh = (mesh if mesh is not None
                     else make_mesh(mesh_spec, device=device or "cuda"))
        self.det_size = int(det_size)
        self.score_thresh = float(score_thresh)
        self.max_faces = int(max_faces)
        self._run = build_sharded_prescan_step(
            self.mesh, scrfd_cfg=scrfd_cfg, arcface_cfg=arcface_cfg,
            det_size=det_size, max_faces=max_faces, dtype=dtype, seed=seed,
            scrfd_vars=scrfd_weights, arcface_vars=arcface_weights,
            use_arcface=use_arcface, clip_face_cfg=clip_face_cfg,
            embed_slots=embed_slots)
        # embed dim comes from the step (differs from arcface_cfg when an
        # .onnx checkpoint or a CLIP tower supplies the encoder)
        self.embed_dim = self._run.embed_dim
        # bank placeholder: distances are recomputed on the host against
        # the live bank, the device result is a cheap byproduct
        self._bank = np.zeros((1, self.embed_dim), np.float32)
        self._bank_mask = np.zeros((1,), bool)

    def _pad_to_mesh(self, frames, valid):
        """The batch dim splits over ``data``: pad to a multiple of the
        data-axis size (repeat last frame, valid=False) so odd batches —
        e.g. a single reference photo through seed_bank — still shard."""
        dp = self.mesh.num_replicas()
        frames = np.asarray(frames)
        valid = np.asarray(valid)
        n = frames.shape[0]
        rem = (-n) % dp
        if rem:
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], rem, axis=0)], 0)
            valid = np.concatenate([valid, np.zeros(rem, bool)])
        return frames, valid, n

    def submit_batch(self, frames, valid, frame_idxs=None):
        frames, valid, n = self._pad_to_mesh(frames, valid)
        out = self._run(frames, self._bank, self._bank_mask,
                        score_thresh=self.score_thresh)
        downloads = {k: start_download(out[k])
                     for k in ("boxes", "kps", "scores", "mask", "feats",
                               "quality")}
        valid = valid.copy()

        def fetch():
            host = {k: d()[:n] for k, d in downloads.items()}
            host["mask"] = host["mask"] & valid[:n, None]
            return host

        return fetch

    def extract_batch(self, frames, valid, frame_idxs=None):
        return self.submit_batch(frames, valid, frame_idxs)()


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
        # the engine's StepTimer for the length of a run: person.detect
        self.timer = NULL_TIMER
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

        with self.timer("person.detect"):
            frames = frames.float()
            padded, scale = letterbox_topleft(frames, self.det_size)
            scales = torch.full((frames.shape[0],), scale,
                                dtype=torch.float32, device=frames.device)
            return detect_persons(self.model, padded, scales, conf,
                                  self.max_det,
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


class OraclePersonBackend:
    """Ground-truth person boxes for tests: each synthetic face's box
    inflated to a plausible body box."""

    def __init__(self, sv, max_det: int = 4, scale: float = 1.0):
        self.sv = sv
        self.max_det = int(max_det)
        self.scale = float(scale)

    def detect_batch(self, frames, valid, frame_idxs=None):
        b = frames.shape[0]
        h, w = frames.shape[1], frames.shape[2]
        boxes = np.zeros((b, self.max_det, 4), np.float32)
        scores = np.zeros((b, self.max_det), np.float32)
        mask = np.zeros((b, self.max_det), bool)
        if frame_idxs is None:
            frame_idxs = np.arange(b)
        for i in range(b):
            if not valid[i]:
                continue
            pls = self.sv.truth.get(int(frame_idxs[i]), [])
            for j, pl in enumerate(pls[: self.max_det]):
                x1, y1, x2, y2 = (v * self.scale for v in pl.box)
                fw, fh = x2 - x1, y2 - y1
                boxes[i, j] = [max(0, x1 - fw), max(0, y1 - 0.5 * fh),
                               min(w, x2 + fw), min(h, y2 + 4 * fh)]
                scores[i, j] = 0.9
                mask[i, j] = True
        return {"boxes": boxes, "scores": scores, "mask": mask}


class OracleBackend:
    """Ground-truth backend over a synthetic video.

    Embeddings are deterministic unit vectors per identity (plus tiny
    box-position-seeded jitter), so bank/threshold logic behaves like real
    embeddings with ~0 intra-identity distance and ~1.0 cross-identity.
    """

    def __init__(self, sv, embed_dim: int = 64, max_faces: int = 4,
                 scale: float = 1.0, noise: float = 0.0):
        self.sv = sv
        self.embed_dim = int(embed_dim)
        self.max_faces = int(max_faces)
        self.scale = float(scale)  # reader downscale vs truth coords
        self.noise = float(noise)

    def identity_feat(self, identity: int) -> np.ndarray:
        v = np.zeros(self.embed_dim, np.float32)
        v[identity % self.embed_dim] = 1.0
        return v

    def extract_batch(self, frames, valid, frame_idxs=None):
        b = frames.shape[0]
        f = self.max_faces
        boxes = np.zeros((b, f, 4), np.float32)
        kps = np.zeros((b, f, 5, 2), np.float32)
        scores = np.zeros((b, f), np.float32)
        mask = np.zeros((b, f), bool)
        feats = np.zeros((b, f, self.embed_dim), np.float32)
        quality = np.zeros((b, f), np.float32)
        if frame_idxs is None:
            frame_idxs = np.arange(b)
        for i in range(b):
            if not valid[i]:
                continue
            pls = self.sv.truth.get(int(frame_idxs[i]), [])
            for j, pl in enumerate(pls[:f]):
                boxes[i, j] = np.asarray(pl.box, np.float32) * self.scale
                kps[i, j] = pl.kps * self.scale
                scores[i, j] = 0.99
                mask[i, j] = True
                v = self.identity_feat(pl.identity)
                if self.noise:
                    rng = np.random.default_rng(
                        int(frame_idxs[i]) * 131 + j)
                    v = v + rng.normal(0, self.noise, v.shape).astype(np.float32)
                feats[i, j] = v / np.linalg.norm(v)
                quality[i, j] = 500.0
        return {"boxes": boxes, "kps": kps, "scores": scores,
                "mask": mask, "feats": feats, "quality": quality}
