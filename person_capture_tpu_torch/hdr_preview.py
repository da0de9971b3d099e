"""HDR preview API shim.

Torch port of ``person_capture_tpu/hdr_preview.py``. The reference's
true-HDR preview is a Windows Vulkan swapchain DLL
(person_capture/hdr_preview.py + hdr_preview/pc_hdr_vulkan.cpp). A GPU
server has no display swapchain either; the preview is tone-mapped SDR
frames rendered by the HDR still renderer (hdr/stills.py, which runs the
fused tone-map kernel of kernels/hdr.py on a GPU) and emitted through the
Engine's ``on_preview`` callback. This module keeps the reference's
availability-probe surface so call-sites port unchanged.
"""

from __future__ import annotations

import numpy as np


def hdr_passthrough_available() -> bool:
    """True-HDR swapchain passthrough (reference: hdr_preview.py:105-314)
    is a Windows/Vulkan feature; here the preview path is always the
    tone-mapped SDR stream."""
    return False


def tonemap_preview_frame(y_plane: np.ndarray, uv_plane: np.ndarray,
                          max_dim: int = 1280,
                          sdr_nits: float = 100.0,
                          tonemap: str = "bt.2390",
                          full_range: bool = False,
                          device: str = "cuda") -> np.ndarray:
    """One P010 frame → dithered SDR BGR preview rendered on ``device``,
    downscaled to ``max_dim`` (replaces
    `HDRPreviewWidget.upload_p010_frame`)."""
    from .hdr.stills import HdrExportParams, render_sdr_crop_from_p010

    h, w = y_plane.shape[:2]
    params = HdrExportParams(tonemap=tonemap, sdr_nits=sdr_nits,
                             full_range=full_range, color_match=False,
                             speckle_cleanup=False, dither=True,
                             device=device)
    bgr = render_sdr_crop_from_p010(y_plane, uv_plane, (0, 0, w, h), params)
    if max_dim and max(bgr.shape[:2]) > max_dim:
        try:
            import cv2
            s = max_dim / max(bgr.shape[:2])
            bgr = cv2.resize(bgr, (int(round(bgr.shape[1] * s)),
                                   int(round(bgr.shape[0] * s))),
                             interpolation=cv2.INTER_AREA)
        except ImportError:
            pass
    return bgr
