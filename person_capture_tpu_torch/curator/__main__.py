"""Curator CLI of the torch port — the flags of ``person_capture_tpu.curator``
(the reference's ``dataset_curator._main`` surface): curate a pool of
crops, optionally against a reference photo.

    python -m person_capture_tpu_torch.curator --pool DIR --out DIR \
        [--ref IMG] [--max N] [--fd-max F] [--sharp-min F] [--mmr-alpha F] \
        [--scene-aware 0|1] [--scene-sim F] [--scene-time-gap F] \
        [--scene-nn-window N] [--dedup-hamm N] [--scene-dedup N] \
        [--scene-soft-cap N] [--scene-soft-penalty F] [--div-bg F] \
        [--div-face F] [--closeup-boost F] [--closeup-thr F] \
        [--profile-yaw F] [--quotas JSON] [--assume-identity] \
        [--device cuda|cpu]

Arg names, defaults and the omit-``--ref``→``assume-identity`` rule match
the reference CLI. ``--device`` is ``cuda`` unless ``cpu`` is given, and
``cuda`` without a CUDA device raises (as ``main.resolve_device``);
``--trt-lib-dir`` is accepted for drop-in compatibility and does nothing.
The earlier spellings (``--max-images``, ``--fd-gate``, ``--lambda``) stay
as hidden aliases.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="person_capture_tpu_torch.curator")
    ap.add_argument("--pool", required=True,
                    help="folder with candidate images (e.g., output/crops)")
    ap.add_argument("--ref", default="",
                    help="optional reference face image(s), ';'-separated "
                         "(omit if pool already identity-filtered)")
    ap.add_argument("--out", required=True,
                    help="output folder for curated dataset")
    ap.add_argument("--max", "--max-images", dest="max_images", type=int,
                    default=200, help="max images")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device")
    ap.add_argument("--trt-lib-dir", default="",
                    help="accepted for reference-CLI compatibility; "
                         "TensorRT is not used (no-op)")
    ap.add_argument("--assume-identity", action="store_true",
                    help="assume all images already passed identity (skip "
                         "the fd gate). Defaults to on when --ref omitted.")
    ap.add_argument("--scene-aware", type=int, choices=[0, 1], default=1,
                    help="scene-aware selection (1=on, 0=off)")
    ap.add_argument("--scene-sim", type=float, default=0.92,
                    help="scene similarity threshold")
    ap.add_argument("--scene-time-gap", type=float, default=4.0,
                    help="max time gap when clustering scenes")
    ap.add_argument("--scene-nn-window", type=int, default=64,
                    help="scene stitching window")
    ap.add_argument("--dedup-hamm", type=int, default=7,
                    help="global dedup hamming threshold")
    ap.add_argument("--scene-dedup", type=int, default=8,
                    help="in-scene dedup hamming threshold")
    ap.add_argument("--scene-soft-cap", type=int, default=0,
                    help="soft cap per scene (0 disables)")
    ap.add_argument("--scene-soft-penalty", "--scene-soft-bonus",
                    dest="scene_soft_penalty", type=float, default=0.08,
                    help="penalty applied when soft cap exceeded")
    ap.add_argument("--mmr-alpha", "--lambda", dest="mmr_alpha", type=float,
                    default=0.75,
                    help="MMR trade-off between quality and diversity (0..1)")
    ap.add_argument("--profile-yaw", type=float, default=50.0,
                    help="yaw threshold in degrees for profile faces")
    ap.add_argument("--div-bg", type=float, default=1.0,
                    help="background diversity weight")
    ap.add_argument("--div-face", type=float, default=0.6,
                    help="face diversity weight")
    ap.add_argument("--closeup-boost", type=float, default=0.25,
                    help="close-up boost multiplier")
    ap.add_argument("--closeup-thr", type=float, default=0.33,
                    help="close-up boost face fraction threshold")
    ap.add_argument("--fd-max", "--fd-gate", dest="fd_max", type=float,
                    default=0.45, help="max allowed face distance gate")
    ap.add_argument("--sharp-min", type=float, default=0.10,
                    help="minimum sharpness gate")
    ap.add_argument("--quotas", type=str, default=None,
                    help="JSON dict of category quotas {cat: [min, max]}")
    # extras of the rebuilt CLI (not in the reference)
    ap.add_argument("--no-clip", action="store_true",
                    help="skip CLIP background embeddings")
    ap.add_argument("--det-size", type=int, default=640)
    ap.add_argument("--scrfd-weights", default="auto",
                    help=".npz checkpoint | auto (bundled) | random")
    ap.add_argument("--arcface-weights", default="auto",
                    help=".npz checkpoint | auto (bundled) | random")
    return ap


def parse_quotas(payload: str):
    """Reference-exact --quotas validation (dataset_curator.py:1865-1877)."""
    import json

    try:
        raw = json.loads(payload)
        if not isinstance(raw, dict):
            raise ValueError("top-level quotas payload must be an "
                             "object/dict")
        quotas = {}
        for key, value in raw.items():
            if not isinstance(value, (list, tuple)) or len(value) != 2:
                raise ValueError(
                    f"quota '{key}' must be [min, max]; got {value!r}")
            quotas[str(key)] = (int(value[0]), float(value[1]))
        return quotas
    except ValueError as exc:
        raise SystemExit(f"Invalid --quotas payload: {exc}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    quotas = parse_quotas(args.quotas) if args.quotas else None
    assume_identity = bool(args.assume_identity or not args.ref)

    import cv2
    import numpy as np

    from ..core.bank import RefBank
    from ..main import resolve_device, resolve_reid
    from ..models import arcface as AF
    from ..models.zoo import bundled_weights_path, resolve_weights
    from ..pipeline.backends import (ClipReidBackend, ScrfdArcFaceBackend,
                                     extract_single_image)
    from .core import Curator

    device = resolve_device(argparse.Namespace(device=args.device))
    # real weights like the main CLI — a random-init SCRFD/ArcFace can never
    # find or identify the reference face
    arc_name = ("arcface_synth" if bundled_weights_path("arcface_synth")
                else "w600k_r50")
    backend = ScrfdArcFaceBackend(
        arcface_cfg=AF.CONFIGS.get(arc_name, AF.W600K_R50),
        det_size=args.det_size, device=device,
        scrfd_weights=resolve_weights(args.scrfd_weights, "scrfd_2.5g"),
        arcface_weights=resolve_weights(args.arcface_weights, arc_name))
    if args.no_clip:
        clip_backend = None
    else:
        # the bundled trained tower through the main CLI's resolution
        reid_cfg, reid_w = resolve_reid("ViT-L-14", "auto")
        clip_backend = ClipReidBackend(cfg=reid_cfg, weights=reid_w,
                                       device=device)

    bank = RefBank(cap=16)
    for p in args.ref.split(";") if args.ref else []:
        if not p:
            continue
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            print(f"cannot read reference: {p}", file=sys.stderr)
            return 1
        out = extract_single_image(backend, img)
        mask = out["mask"][0]
        if mask.any():
            j = int(np.argmax(np.where(mask, out["quality"][0], -1.0)))
            bank.update(out["feats"][0][j], float(out["quality"][0][j]))
    if bank.size == 0 and not assume_identity:
        print("no face found in reference photo(s)", file=sys.stderr)
        return 1

    cur = Curator(backend, bank, clip_backend=clip_backend,
                  progress=lambda phase, done, total:
                  print(f"[curate] {phase} {done}/{total}"))
    res = cur.run(args.pool, args.out, max_images=args.max_images,
                  fd_gate=args.fd_max, lam=args.mmr_alpha,
                  dedup_hamm=max(0, args.dedup_hamm),
                  sharp_min=max(0.0, min(1.0, args.sharp_min)),
                  assume_identity=assume_identity,
                  scene_aware=bool(args.scene_aware),
                  scene_sim=args.scene_sim,
                  scene_time_gap=args.scene_time_gap,
                  scene_nn_window=max(0, args.scene_nn_window),
                  scene_dedup=max(0, args.scene_dedup),
                  scene_softcap=max(0, args.scene_soft_cap),
                  scene_penalty=max(0.0, args.scene_soft_penalty),
                  profile_yaw_thresh=max(0.0, args.profile_yaw),
                  div_bg=max(0.0, args.div_bg),
                  div_face=max(0.0, args.div_face),
                  closeup_boost=max(0.0, args.closeup_boost),
                  closeup_thr=max(0.0, min(1.0, args.closeup_thr)),
                  # reference counts → mmr_select's (min_count, max_frac)
                  quotas={k: (int(mn), mx / max(1, args.max_images))
                          for k, (mn, mx) in quotas.items()}
                  if quotas else None)
    m = res["metrics"]
    print(f"selected {m['selected']}/{m['pool']} "
          f"(scenes={m['scenes']}, mean_q={m['mean_quality']:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
