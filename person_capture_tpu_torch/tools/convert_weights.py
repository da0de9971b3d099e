"""Offline weight conversion: reference checkpoints → framework ``.npz``.

Converts the reference's model files into the flat-npz flax-variable format
(tools/weights.py):

  * SCRFD ONNX (``scrfd_2.5g_bnkps.onnx`` / ``scrfd_10g_bnkps.onnx``)
  * ArcFace ONNX (``w600k_r50.onnx`` / ``glintr100.onnx``)
  * YOLOv8 ultralytics ``.pt`` (torch)
  * OpenCLIP ViT ``.pt``/``.bin`` (torch)

Every tensor is stored under ``src/<source name>``, re-oriented into the
flax layout; ``models/loaders.py`` maps those names onto the model trees:
  - conv kernels: ONNX/torch OIHW → flax HWIO
  - dense kernels: torch [out, in] → flax [in, out]
  - BatchNorm: (scale, bias, mean, var) → flax params/batch_stats split

``--dump-names`` prints the source parameter inventory so mappings can be
extended when a new checkpoint layout appears.

Copied from ``person_capture_tpu/tools/convert_weights.py``; this package
has torch, so :func:`torch_param_dict` imports it directly. An ultralytics
``.pt`` pickles ultralytics classes and loads only where that package is
installed; a plain state dict loads anywhere.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from .weights import save_npz_variables


def onnx_param_dict(path: str) -> Dict[str, np.ndarray]:
    """Graph initializers from an .onnx file. Prefers the installed `onnx`
    package; falls back to the dependency-free wire-format reader
    (tools/onnx_lite.py)."""
    try:
        import onnx
        from onnx import numpy_helper

        model = onnx.load(path)
        return {init.name: numpy_helper.to_array(init)
                for init in model.graph.initializer}
    except ImportError:
        from .onnx_lite import onnx_initializers

        return onnx_initializers(path)


def torch_param_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    state = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if isinstance(state, dict) and "model" in state \
            and hasattr(state["model"], "state_dict"):
        state = state["model"].float().state_dict()
    return {k: np.asarray(v.detach().cpu().numpy())
            for k, v in state.items() if hasattr(v, "detach")}


def conv_oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def dense_oi_to_io(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convert_weights")
    ap.add_argument("--src", required=True, help="source checkpoint")
    ap.add_argument("--kind", required=True,
                    choices=["scrfd", "arcface", "yolov8", "clip"])
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--dump-names", action="store_true",
                    help="print the source parameter inventory and exit")
    args = ap.parse_args(argv)

    if args.src.endswith(".onnx"):
        params = onnx_param_dict(args.src)
    else:
        params = torch_param_dict(args.src)

    if args.dump_names:
        for k, v in params.items():
            print(k, tuple(v.shape))
        return 0

    # Generic structural conversion: re-orient every tensor into the
    # framework's layout conventions and store it under its source name;
    # models/loaders.py consumes these through its name maps.
    out: Dict[str, np.ndarray] = {}
    for name, w in params.items():
        if w.ndim == 4:
            out[f"src/{name}"] = conv_oihw_to_hwio(w)
        elif w.ndim == 2:
            out[f"src/{name}"] = dense_oi_to_io(w)
        else:
            out[f"src/{name}"] = w
    save_npz_variables(args.out, out)
    print(f"wrote {len(out)} tensors to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
