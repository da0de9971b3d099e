"""HDR speckle diagnostics.

Rebuild of the reference's root-cause pipeline (gui_app.py:8780-9343):
render the same HDR crop through multiple tone-map/range variants, compute
per-plane statistics, speckle counts and pairwise diffs, and dump a JSON
report plus the intermediate renders — a manual A/B harness for the color
pipeline. All renders go through the device chain on the base parameters'
device (no subprocesses): with the plain PQ configuration, each variant is
one launch of the fused tone-map kernel.

Copied from ``person_capture_tpu/hdr/diagnostics.py``; the speckle mask is
computed on the same device as the renders.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.cleanup import detect_speckles
from .stills import HdrExportParams, render_sdr_crop_from_p010

DIAG_VARIANTS = [
    {"name": "bt2390_limited", "tonemap": "bt.2390", "full_range": False},
    {"name": "bt2390_full", "tonemap": "bt.2390", "full_range": True},
    {"name": "mobius_limited", "tonemap": "mobius", "full_range": False},
    {"name": "hable_limited", "tonemap": "hable", "full_range": False},
    {"name": "clip_limited", "tonemap": "clip", "full_range": False},
]


def plane_stats(bgr: np.ndarray) -> Dict:
    out = {}
    for i, name in enumerate(("b", "g", "r")):
        plane = bgr[..., i].astype(np.float64)
        out[name] = {
            "mean": round(float(plane.mean()), 3),
            "std": round(float(plane.std()), 3),
            "p01": float(np.percentile(plane, 1)),
            "p99": float(np.percentile(plane, 99)),
            "min": float(plane.min()),
            "max": float(plane.max()),
        }
    return out


def run_speckle_diagnostics(y_plane: np.ndarray, uv_plane: np.ndarray,
                            crop_xyxy, out_dir: str,
                            base_params: Optional[HdrExportParams] = None,
                            save_intermediates: bool = True) -> Dict:
    """Render variants, measure, dump JSON (+ PNGs). Returns the report."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    os.makedirs(out_dir, exist_ok=True)
    base = base_params or HdrExportParams()
    t0 = time.perf_counter()
    renders: Dict[str, np.ndarray] = {}
    report: Dict = {"crop": [int(v) for v in crop_xyxy], "variants": {}}
    for var in DIAG_VARIANTS:
        params = HdrExportParams(**{**base.__dict__,
                                    "tonemap": var["tonemap"],
                                    "full_range": var["full_range"],
                                    "color_match": False,
                                    "speckle_cleanup": False,
                                    "dither": False})
        bgr = render_sdr_crop_from_p010(y_plane, uv_plane, crop_xyxy, params)
        renders[var["name"]] = bgr
        speckles = int(detect_speckles(
            torch.from_numpy(bgr).to(params.device)).sum())
        report["variants"][var["name"]] = {
            "stats": plane_stats(bgr),
            "speckle_pixels": speckles,
        }
        if save_intermediates and cv2 is not None:
            cv2.imwrite(os.path.join(out_dir, f"diag_{var['name']}.png"), bgr)

    # pairwise diffs vs the primary variant
    primary = DIAG_VARIANTS[0]["name"]
    base_img = renders[primary].astype(np.int16)
    report["diffs_vs_" + primary] = {}
    for name, img in renders.items():
        if name == primary:
            continue
        d = np.abs(img.astype(np.int16) - base_img)
        report["diffs_vs_" + primary][name] = {
            "mean_abs": round(float(d.mean()), 3),
            "p99_abs": float(np.percentile(d, 99)),
            "max_abs": int(d.max()),
        }
    report["wall_s"] = round(time.perf_counter() - t0, 3)
    with open(os.path.join(out_dir, "speckle_diag.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    return report
