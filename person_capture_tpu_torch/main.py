"""CLI of the torch port — the same flags as ``person_capture_tpu.main``,
driving the PyTorch/CUDA pipeline:

    python -m person_capture_tpu_torch.main --video V --ref R --out OUT

Runs on the CUDA device unless ``--device cpu`` is given. Weights load
from the bundled or user flax ``.npz`` files, converted torch dumps
(``tools/convert_weights.py``), ultralytics and open_clip ``.pt`` state
dicts (``models/loaders.py``) and insightface ONNX graphs
(``models/onnx_zoo.py``). ``--mesh`` splits each batch over several
devices (parallel/mesh.py), and ``--multihost`` runs the same command in
several processes, each computing its share (parallel/multihost.py).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser(require_video: bool = True) -> argparse.ArgumentParser:
    """``require_video=False`` lets corpus frontends (sweep.py) reuse the
    full flag surface while supplying videos their own way."""
    ap = argparse.ArgumentParser(prog="person_capture_tpu_torch.main")
    ap.add_argument("--video", required=require_video, default="",
                    help="path to video file")
    ap.add_argument("--ref", required=True, action="append",
                    help="reference image(s) of the target person; "
                         "repeatable and/or ';'-separated")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--ratio", default="2:3", help="crop aspect ratio W:H")
    ap.add_argument("--frame-stride", type=int, default=2)
    ap.add_argument("--min-det-conf", type=float, default=0.35)
    ap.add_argument("--face-thresh", type=float, default=0.32)
    ap.add_argument("--reid-thresh", type=float, default=0.38)
    ap.add_argument("--combine", default="min",
                    choices=["min", "avg", "face_priority"])
    ap.add_argument("--match-mode", default="face_only",
                    choices=["face_only", "either", "both", "reid_only"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--save-annot", action="store_true")
    ap.add_argument("--yolo", default="yolov8n.pt")
    ap.add_argument("--min-sharpness", type=float, default=0.0)
    # TPU-era additions, kept by the port
    ap.add_argument("--prescan", dest="prescan", action="store_true",
                    default=False, help="enable span pre-scan")
    ap.add_argument("--batch", type=int, default=64,
                    help="frames per fused device step")
    ap.add_argument("--det-size", type=int, default=640)
    ap.add_argument("--min-gap-sec", type=float, default=0.0)
    ap.add_argument("--face-det-conf", type=float, default=0.5,
                    help="face detector candidate threshold")
    ap.add_argument("--scrfd-weights", default="auto",
                    help=".npz | .onnx checkpoint | auto (bundled "
                         "synthetic weights) | random")
    ap.add_argument("--arcface-weights", default="auto",
                    help=".npz (flax or converted torch) | .onnx "
                         "checkpoint | auto (bundled synthetic weights) | "
                         "random")
    ap.add_argument("--face-model", default="scrfd_2.5g")
    ap.add_argument("--arcface-model", default="auto",
                    help="w600k_r50 | glintr100 | arcface_synth | auto "
                         "(bundled trained embedder when present)")
    ap.add_argument("--reid-weights", default="auto",
                    help="ReID tower checkpoint: .npz | open_clip .pt | "
                         "auto (bundled trained clip_reid_s) | random")
    ap.add_argument("--mesh", default="",
                    help="device mesh spec, e.g. 'data:4,model:2'; "
                         "''=1 device")
    # multi-host: run the same command in every process. Under torchrun
    # the address comes from its environment (pass --multihost alone);
    # manual clusters pass all three (parallel/multihost.py)
    ap.add_argument("--multihost", action="store_true", default=False,
                    help="join the torch.distributed process group "
                         "(torchrun's environment when the address flags "
                         "are unset)")
    ap.add_argument("--coordinator", default="",
                    help="coordinator address host:port (multi-host)")
    ap.add_argument("--num-processes", type=int, default=0,
                    help="total process count (multi-host)")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="this process's index (multi-host)")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--preset", default="",
                    help="SessionConfig JSON preset (reference preset files "
                         "load unchanged); explicit flags override it")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any SessionConfig field by name "
                         "(repeatable; applied last)")
    return ap


def build_config(args, ap):
    """CLI args (+ optional --preset JSON, + --set overrides) → SessionConfig.
    Precedence: preset < explicitly-passed flags < --set."""
    from .config import SessionConfig

    if args.preset:
        with open(args.preset) as fh:
            cfg = SessionConfig.from_json(fh.read())
    else:
        cfg = SessionConfig()

    def flag(dest: str, field: str) -> None:
        """Apply a CLI flag onto cfg; with a preset loaded, only flags the
        user actually passed (value != parser default) override it."""
        v = getattr(args, dest)
        if not args.preset or v != ap.get_default(dest):
            setattr(cfg, field, v)

    cfg.video = args.video
    cfg.ref = ";".join(args.ref) if isinstance(args.ref, list) else args.ref
    cfg.out_dir = args.out
    flag("ratio", "ratio")
    flag("frame_stride", "frame_stride")
    flag("min_det_conf", "min_det_conf")
    flag("face_thresh", "face_thresh")
    flag("reid_thresh", "reid_thresh")
    flag("combine", "combine")
    flag("match_mode", "match_mode")
    flag("device", "device")
    # the prescan cache keys on cfg.face_model (the bank's embedding space
    # follows the detector/embedder family) — without this, runs with
    # different --face-model values collided on the same cache entry
    flag("face_model", "face_model")
    flag("save_annot", "save_annot")
    flag("yolo", "yolo_model")
    flag("min_sharpness", "min_sharpness")
    flag("min_gap_sec", "min_gap_sec")
    flag("face_det_conf", "face_det_conf")
    flag("prescan", "prescan_enable")
    flag("batch", "tpu_batch_frames")
    flag("mesh", "tpu_mesh")
    flag("compute_dtype", "tpu_compute_dtype")

    # --set KEY=VALUE: typed override of any SessionConfig field (applied
    # last; replaces the reference's env-var side channel for one-offs)
    import json as _json

    for ov in args.overrides:
        k, sep, v = ov.partition("=")
        if not sep or not hasattr(cfg, k):
            ap.error(f"--set {ov!r}: unknown config field {k!r}")
        cur = getattr(cfg, k)
        try:
            if isinstance(cur, bool):
                val = v.strip().lower() in ("1", "true", "yes", "on")
            elif isinstance(cur, int):
                val = int(v)
            elif isinstance(cur, float):
                val = float(v)
            elif isinstance(cur, (tuple, list)):
                val = type(cur)(_json.loads(v))
            else:
                val = v
        except (ValueError, _json.JSONDecodeError) as e:
            ap.error(f"--set {ov!r}: {e}")
        setattr(cfg, k, val)
    return cfg


def resolve_device(cfg):
    """``cfg.device`` → ``torch.device``. ``cuda`` without a CUDA device
    raises: the port never moves to the CPU unasked."""
    import torch

    name = str(cfg.device or "cuda").lower()
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device {cfg.device!r}: the torch port runs on "
                         f"'cuda' or 'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    return torch.device(name)


def maybe_pin_platform(cfg) -> None:
    """The JAX CLI pins its platform here; the port checks that the device
    it was asked for exists (:func:`resolve_device`), before any backend
    is built."""
    resolve_device(cfg)


def resolve_compile_cache_dir(cfg) -> str:
    """Resolve ``cfg.tpu_compile_cache_dir`` to a directory or ''.

    "auto" (the default) -> $XDG_CACHE_HOME/person_capture_tpu_torch (or
    ~/.cache/...); ""/"off"/"none"/"0" -> disabled; anything else is an
    explicit directory. ``doctor`` checks it; the port keeps no compiled
    programs there (:func:`maybe_enable_compile_cache`)."""
    d = str(getattr(cfg, "tpu_compile_cache_dir", "") or "").strip()
    if d.lower() in ("", "off", "none", "0", "false"):
        return ""
    if d.lower() == "auto":
        root = os.environ.get("XDG_CACHE_HOME",
                              os.path.join(os.path.expanduser("~"),
                                           ".cache"))
        return os.path.join(root, "person_capture_tpu_torch")
    return d


def maybe_enable_compile_cache(cfg) -> None:
    """No-op: eager torch compiles no programs to cache (the hand-written
    kernels are built once per checkout into ``build/torch_kernels/``)."""


def maybe_init_multihost(args, out_dir: str) -> str:
    """Join the process group when requested; returns the output root this
    process should write under.

    Must run BEFORE the first backend is built (the mesh lists every
    process's devices). Every process runs the identical pipeline; only the
    primary writes user-visible outputs — the others keep their
    (deterministic, identical) artifacts in a scratch subdir so shared
    filesystems never see write races."""
    if not (args.multihost or args.coordinator):
        return out_dir
    from .parallel import multihost as MH

    MH.initialize(
        coordinator=args.coordinator or None,
        num_processes=args.num_processes if args.num_processes > 0
        else None,
        process_id=args.process_id if args.process_id >= 0 else None)
    if not MH.is_primary():
        out_dir = os.path.join(out_dir, f".proc{MH.process_index()}")
    return out_dir


def resolve_yolo(yolo_model: str):
    """Resolve the person-detector spec to (yolo_cfg, weights).

    Bundled synthetic-trained weights for known names; a user-supplied
    checkpoint path loads for real (ultralytics ``.pt`` via
    models/loaders.load_yolov8_torch, flax .npz via the zoo). A spec that
    resolves to nothing raises ``FileNotFoundError`` — never a silent
    random-init run."""
    from .models import yolov8 as YV
    from .models.zoo import BUNDLED, resolve_weights

    yolo_spec = str(yolo_model or "yolov8n.pt")
    yolo_name = (os.path.splitext(os.path.basename(yolo_spec))[0]
                 .replace("-", "_")) or "yolov8n"
    yolo_cfg = YV.CONFIGS.get(yolo_name, YV.YOLOV8N)
    if os.path.isfile(yolo_spec):
        if yolo_spec.lower().endswith((".pt", ".pth")):
            from .models.bridge import flax_variables
            from .models.loaders import load_yolov8_torch
            from .tools.convert_weights import torch_param_dict

            return yolo_cfg, load_yolov8_torch(
                flax_variables(YV.YoloV8(yolo_cfg)), yolo_cfg,
                torch_param_dict(yolo_spec), strict=True)
        return yolo_cfg, resolve_weights(yolo_spec, yolo_name)
    if yolo_name not in BUNDLED:
        raise FileNotFoundError(
            f"--yolo {yolo_spec!r}: not a file and no bundled weights "
            f"for {yolo_name!r}")
    return yolo_cfg, resolve_weights("auto", yolo_name)


def resolve_reid(backbone: str, weights_spec: str = "auto"):
    """Resolve the ReID tower to ``(clip_cfg, variables|None)``.

    "auto" takes the bundled synthetic-trained compact tower (the arch
    becomes ``clip_reid_s``, as arcface "auto" takes the bundled embedder);
    "random" keeps the requested arch at random init. An explicit
    checkpoint loads the requested arch: open_clip torch state dicts
    (``.pt``/``.pth``/``.bin``) via models/loaders.load_clip_torch, flax
    ``.npz`` via the zoo. Any other spec that is not a file raises
    ``FileNotFoundError``."""
    from .models import clip_vit as CV
    from .models.zoo import resolve_weights

    spec = (weights_spec or "auto").strip()
    cfg = CV.CONFIGS.get(backbone, CV.VIT_L_14)
    if spec.lower() in ("random", "none"):
        return cfg, None
    if os.path.isfile(spec):
        if spec.lower().endswith((".pt", ".pth", ".bin")):
            from .models.bridge import flax_variables
            from .models.loaders import load_clip_torch
            from .tools.convert_weights import torch_param_dict

            return cfg, load_clip_torch(flax_variables(CV.ClipViT(cfg)), cfg,
                                        torch_param_dict(spec))
        return cfg, resolve_weights(spec, cfg.name)
    if spec.lower() not in ("auto", ""):
        raise FileNotFoundError(
            f"--reid-weights {spec!r}: not a file and not auto/random")
    w = resolve_weights("auto", "clip_reid_s")
    if w is not None:
        return CV.REID_S, w
    return cfg, None


def build_runtime(cfg, args, ap) -> dict:
    """Resolve weights and build every model backend the run needs, ONCE
    (reusable across videos). Returns the same keys as the JAX package's
    ``build_runtime``."""
    import torch

    from .models import arcface as AF
    from .models import clip_vit as CV
    from .models import scrfd as SD
    from .models import yolov8 as YV
    from .models.zoo import bundled_weights_path, resolve_weights
    from .pipeline.backends import (ClipReidBackend, LazyBackend,
                                    ScrfdArcFaceBackend,
                                    ShardedScrfdArcFaceBackend,
                                    YoloPersonBackend)

    device = resolve_device(cfg)
    dtype = (torch.bfloat16 if cfg.tpu_compute_dtype == "bfloat16"
             else torch.float32)

    # face detector config: SCRFD names resolve from models/scrfd.py;
    # "yolov8n-face"-style names select the YOLOv8-face detector
    fm = os.path.basename(args.face_model)
    for ext in (".pt", ".pth", ".onnx", ".npz"):
        if fm.lower().endswith(ext):       # NOT splitext: "scrfd_2.5g"
            fm = fm[:-len(ext)]            # has a dot inside the name
            break
    fm = fm.replace("-", "_").replace("_bnkps", "")
    if fm in YV.CONFIGS and YV.CONFIGS[fm].kpt_shape[0]:
        face_cfg = YV.CONFIGS[fm]
    else:
        face_cfg = SD.CONFIGS.get(fm, SD.SCRFD_2_5G)
    scrfd_w = resolve_weights(args.scrfd_weights, face_cfg.name)

    arc_model_name = args.arcface_model
    if arc_model_name == "auto":
        arc_model_name = ("arcface_synth"
                          if bundled_weights_path("arcface_synth")
                          else "w600k_r50")
    arc_cfg = AF.CONFIGS.get(arc_model_name, AF.W600K_R50)
    # an explicit checkpoint other than ONNX (a flax .npz or a converted
    # torch dump) loads through models/loaders, as in the JAX runtime
    spec = args.arcface_weights.lower()
    if spec in ("auto", ""):
        arc_w = resolve_weights("auto", arc_model_name)
    elif spec in ("random", "none"):
        arc_w = None
    elif spec.endswith(".onnx"):
        arc_w = resolve_weights(args.arcface_weights, arc_model_name)
    else:
        from .models.bridge import flax_variables
        from .models.loaders import load_checkpoint

        arc_w = load_checkpoint(args.arcface_weights, "arcface",
                                flax_variables(AF.IResNet(arc_cfg)), arc_cfg)

    # use_arcface off: a CLIP tower embeds the face chips, at random init
    # as in the JAX runtime, which passes no CLIP-face weights either
    clip_face_cfg = (None if cfg.use_arcface
                     else CV.CONFIGS.get(cfg.clip_face_backbone))

    def face_backend(det_size: int, embed_slots: int = 0):
        if cfg.tpu_mesh:
            return ShardedScrfdArcFaceBackend(
                mesh_spec=cfg.tpu_mesh, scrfd_cfg=face_cfg,
                arcface_cfg=arc_cfg, det_size=det_size,
                score_thresh=cfg.face_det_conf, max_faces=cfg.tpu_max_faces,
                use_arcface=cfg.use_arcface, clip_face_cfg=clip_face_cfg,
                embed_slots=embed_slots, dtype=dtype, device=device,
                scrfd_weights=scrfd_w, arcface_weights=arc_w)
        return ScrfdArcFaceBackend(
            scrfd_cfg=face_cfg, arcface_cfg=arc_cfg, det_size=det_size,
            score_thresh=cfg.face_det_conf, max_faces=cfg.tpu_max_faces,
            use_arcface=cfg.use_arcface, clip_face_cfg=clip_face_cfg,
            embed_slots=embed_slots, dtype=dtype, device=device,
            scrfd_weights=scrfd_w, arcface_weights=arc_w)

    backend = face_backend(args.det_size,
                           int(getattr(cfg, "tpu_embed_slots", 0) or 0))
    # high-imgsz full-frame re-probe backend (reference full-frame face
    # short-circuit): the same module at another size, built on first use.
    # It mirrors the primary's embedder: a CLIP-face primary with an
    # ArcFace rescue would score one RefBank in two embedding spaces. Mesh
    # runs get the same rescue with its batch data-parallel over the mesh
    fullframe_backend = None
    if (cfg.face_fullframe_when_missed
            and int(cfg.face_fullframe_imgsz) > int(args.det_size)):
        fullframe_backend = LazyBackend(
            lambda: face_backend(int(cfg.face_fullframe_imgsz)))
    # the person detector builds when the match mode needs it and for
    # body-aware compose association (compose_detect_person_for_face,
    # default on). Like the JAX runtime, it takes neither --det-size nor
    # --compute-dtype: det 640 and bf16 are its own defaults; nor does the
    # ReID tower (bf16 unless told otherwise)
    person_backend = None
    reid_backend = None
    if (cfg.match_mode != "face_only" or not cfg.skip_yolo_when_faceonly
            or cfg.compose_detect_person_for_face):
        try:
            yolo_cfg, yolo_w = resolve_yolo(cfg.yolo_model)
        except FileNotFoundError as e:
            ap.error(str(e))
        person_backend = YoloPersonBackend(
            cfg=yolo_cfg, conf=cfg.min_det_conf, weights=yolo_w,
            device=device)
    if cfg.match_mode in ("either", "both", "reid_only"):
        cfg.disable_reid = False
        try:
            reid_cfg, reid_w = resolve_reid(cfg.reid_backbone,
                                            args.reid_weights)
        except FileNotFoundError as e:
            ap.error(str(e))
        reid_backend = ClipReidBackend(cfg=reid_cfg, weights=reid_w,
                                       device=device)
    return {"inner_face": backend, "face_cfg": face_cfg,
            "person": person_backend, "reid": reid_backend,
            "fullframe": fullframe_backend}


def make_engine(cfg, runtime: dict, status=None, progress=None,
                on_preview=None):
    """Engine over a shared :func:`build_runtime` — the per-video pieces
    (recovery ladder state, engine callbacks) are fresh; the heavy model
    backends are shared. ``on_preview(img, frame_idx)`` receives preview
    frames (tone-mapped from the P010 stream for an HDR source)."""
    from .pipeline.engine import Engine
    from .pipeline.recovery import RecoveringFaceBackend, RecoveryPolicy

    # batched recovery ladder (rotations / scale-TTA / edge-pad) around the
    # face backend — reference face_embedder.py:2251-2443 semantics
    policy = RecoveryPolicy.from_config(cfg)
    # ±45/±135° probes only with the YOLO-face backend (reference
    # face_embedder.py:1935-2036 scopes them to the YOLO path)
    policy.affine_probes = bool(
        getattr(runtime["face_cfg"], "kpt_shape", (0, 0))[0])
    face = RecoveringFaceBackend(runtime["inner_face"], policy)
    return Engine(cfg, face, person_backend=runtime["person"],
                  reid_backend=runtime["reid"],
                  fullframe_backend=runtime["fullframe"],
                  status=status or (lambda m: print(f"[pc] {m}")),
                  progress=progress or (lambda p: None),
                  on_preview=on_preview)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    cfg = build_config(args, ap)
    maybe_pin_platform(cfg)
    cfg.out_dir = maybe_init_multihost(args, cfg.out_dir)
    runtime = build_runtime(cfg, args, ap)
    eng = make_engine(cfg, runtime)
    result = eng.run()
    if not result.ok:
        print(f"FAILED: {result.error}", file=sys.stderr)
        return 1
    mp = result.mainpass
    print(f"Done. Hits: {len(mp.hits) if mp else 0}. "
          f"Index: {cfg.out_dir}/index.csv")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
