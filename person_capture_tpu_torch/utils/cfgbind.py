"""GUI-free helpers for binding SessionConfig fields to controls.

Copied from ``person_capture_tpu/utils/cfgbind.py``; it reads the port's
``SessionConfig``, whose ``device`` default is ``"cuda"`` (a text field,
as the JAX package's ``"tpu"`` is).

The reference hand-builds ~200 widgets (gui_app.py:13558-15090); here the
control surface is *generated* from the dataclass — every field gets a
typed control, grouped into collapsible sections by name prefix — so new
config keys appear in the GUI automatically. This module holds the logic
that needs tests (type coercion, grouping); gui_app.py only instantiates
widgets from it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from ..config import SessionConfig

# section → prefixes (first match wins; order matters)
SECTIONS: List[Tuple[str, Tuple[str, ...]]] = [
    ("Pre-scan", ("prescan_",)),
    ("HDR", ("hdr_", "wic_", "tm_", "sdr_")),
    ("Curation", ("curate_",)),
    ("Compose", ("compose_", "crop_", "smart_crop", "ratio",
                 "side_guard", "face_max_frac", "face_min_frac",
                 "face_anchor", "head_")),
    ("Lock / faceless", ("lock_", "faceless_", "iou_gate",
                         "suppress_negatives", "neg_", "max_negatives")),
    ("Face detection", ("face_", "rot_", "scrfd", "arcface")),
    ("Person / ReID", ("reid_", "yolo", "min_det_conf", "skip_yolo",
                       "person_", "drop_reid", "disable_reid")),
    ("Preview / output", ("preview_", "save_", "jpg_", "out_", "debug",
                          "overlay_", "annot", "async_save")),
    ("Performance", ("tpu_", "seek_", "frame_stride", "batch",
                     "decode_", "log_interval")),
]
DEFAULT_SECTION = "General"

# fields that are pathing/identity, not tunables — stay in the main form
SKIP_FIELDS = {"video", "ref", "out_dir"}


def group_for_field(name: str) -> str:
    for section, prefixes in SECTIONS:
        if any(name.startswith(p) for p in prefixes):
            return section
    return DEFAULT_SECTION


def grouped_fields() -> Dict[str, List[Tuple[str, Any]]]:
    """section → [(field_name, default_value)] over all SessionConfig
    fields (minus paths)."""
    out: Dict[str, List[Tuple[str, Any]]] = {}
    for f in dataclasses.fields(SessionConfig):
        if f.name in SKIP_FIELDS:
            continue
        default = f.default
        if default is dataclasses.MISSING:
            if f.default_factory is not dataclasses.MISSING:  # type: ignore
                default = f.default_factory()  # type: ignore
            else:
                default = None
        out.setdefault(group_for_field(f.name), []).append((f.name, default))
    return out


def coerce_field_value(default: Any, raw: Any) -> Any:
    """Parse a widget value back into the field's type (bool/int/float/str/
    tuple-of-numbers)."""
    if isinstance(default, bool):
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    if isinstance(default, int) and not isinstance(default, bool):
        return int(float(raw))
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, tuple):
        if isinstance(raw, (tuple, list)):
            vals = list(raw)
        else:
            vals = [v for v in str(raw).replace("(", "").replace(")", "")
                    .replace(",", " ").split() if v]
        elem = default[0] if default else 0.0
        conv = (int if isinstance(elem, int) and not isinstance(elem, bool)
                else float)
        return tuple(conv(v) for v in vals)
    return type(default)(raw) if default is not None else raw


def widget_kind(default: Any) -> str:
    """Which control a field needs: check | int | float | tuple | text."""
    if isinstance(default, bool):
        return "check"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    if isinstance(default, tuple):
        return "tuple"
    return "text"
