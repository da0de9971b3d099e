"""Checkpoint name-mapping: official torch layouts → our flax trees.

The converter (tools/convert_weights.py) dumps source tensors under
``src/<original name>`` with layouts already re-oriented (conv OIHW→HWIO,
dense [out,in]→[in,out]). This module maps those names onto the flax module
tree so real checkpoints load:

  * ArcFace: the official insightface ``iresnet`` torch layout
    (conv1/bn1/prelu, layer{1..4}.{i}.{bn1,conv1,bn2,prelu,conv2,bn3,
    downsample.{0,1}}, bn2, fc, features).
  * CLIP ViT: the open_clip visual tower layout.

Shapes are validated against the target tree; a clear error lists any
mismatch instead of silently mis-loading.

Copied from ``person_capture_tpu/models/loaders.py``. The target tree (the
template each ``load_*_torch`` fills) is a nested dict of numpy arrays in
flax names: :func:`.bridge.flax_variables` of the port's module. The
result loads into the torch modules through ``bridge.load_*``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def _copy_tree(tree):
    """A deep numpy copy of a nested variables dict (the loaders fill it
    in place)."""
    return {k: _copy_tree(v) if isinstance(v, Mapping) else np.array(v)
            for k, v in tree.items()}


def _bn(prefix: str) -> Dict[str, str]:
    """torch BatchNorm tensor names for a given prefix."""
    return {"scale": f"{prefix}.weight", "bias": f"{prefix}.bias",
            "mean": f"{prefix}.running_mean", "var": f"{prefix}.running_var"}


def arcface_name_map(cfg) -> Dict[Tuple[str, ...], str]:
    """flax path (tuple under params/batch_stats collections prefixed by the
    collection name) → torch source name."""
    m: Dict[Tuple[str, ...], str] = {}

    def add_bn(flax_scope: str, torch_prefix: str):
        names = _bn(torch_prefix)
        m[("params", flax_scope, "scale")] = names["scale"]
        m[("params", flax_scope, "bias")] = names["bias"]
        m[("batch_stats", flax_scope, "mean")] = names["mean"]
        m[("batch_stats", flax_scope, "var")] = names["var"]

    # stem
    m[("params", "Conv_0", "kernel")] = "conv1.weight"
    add_bn("BatchNorm_0", "bn1")
    m[("params", "PReLU_0", "alpha")] = "prelu.weight"

    # blocks (flax numbers IBasicBlock sequentially across stages)
    k = 0
    for stage, nblocks in enumerate(cfg.stage_blocks, start=1):
        for bi in range(nblocks):
            t = f"layer{stage}.{bi}"
            scope = f"IBasicBlock_{k}"
            add_bn(f"{scope}/BatchNorm_0", f"{t}.bn1")
            m[("params", f"{scope}/Conv_0", "kernel")] = f"{t}.conv1.weight"
            add_bn(f"{scope}/BatchNorm_1", f"{t}.bn2")
            m[("params", f"{scope}/PReLU_0", "alpha")] = f"{t}.prelu.weight"
            m[("params", f"{scope}/Conv_1", "kernel")] = f"{t}.conv2.weight"
            add_bn(f"{scope}/BatchNorm_2", f"{t}.bn3")
            if bi == 0:  # downsample on the first block of each stage
                m[("params", f"{scope}/Conv_2", "kernel")] = \
                    f"{t}.downsample.0.weight"
                add_bn(f"{scope}/BatchNorm_3", f"{t}.downsample.1")
            k += 1

    # head: bn2 → BatchNorm_1, fc → Dense_0, features → BatchNorm_2
    add_bn("BatchNorm_1", "bn2")
    m[("params", "Dense_0", "kernel")] = "fc.weight"
    m[("params", "Dense_0", "bias")] = "fc.bias"
    add_bn("BatchNorm_2", "features")
    return m


def _get_path(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _set_path(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def _flatten_scope(path_str: str):
    return tuple(path_str.split("/"))


def load_arcface_torch(variables, cfg, src: Dict[str, np.ndarray],
                       strict: bool = True):
    """Fill our flax variables from a converted torch state dict.

    ``src`` keys may carry the converter's ``src/`` prefix. Conv kernels must
    already be HWIO and dense kernels [in, out] (the converter re-orients);
    raw torch layouts are detected by shape and re-oriented here as well.
    The fc kernel additionally permutes its input dim from torch's C·H·W
    flattening to our H·W·C flattening.
    """
    src = {k[4:] if k.startswith("src/") else k: np.asarray(v)
           for k, v in src.items()}
    out = _copy_tree(variables)
    name_map = arcface_name_map(cfg)
    missing = []
    for path, torch_name in name_map.items():
        if torch_name not in src:
            missing.append(torch_name)
            continue
        w = src[torch_name]
        coll, scope, leaf = path[0], _flatten_scope(path[1]), path[2]
        full = (coll,) + scope + (leaf,)
        try:
            target = _get_path(out, full)
        except KeyError as e:
            raise KeyError(f"flax path not found: {full}") from e
        w = _orient(w, np.asarray(target), torch_name, cfg)
        if w.shape != np.asarray(target).shape:
            raise ValueError(
                f"shape mismatch for {torch_name} -> {full}: "
                f"{w.shape} vs {np.asarray(target).shape}")
        _set_path(out, full, w.astype(np.asarray(target).dtype))
    if strict and missing:
        raise KeyError(f"missing tensors in checkpoint: {missing[:8]}"
                       f"{'…' if len(missing) > 8 else ''}")
    return out


def _orient(w: np.ndarray, target: np.ndarray, name: str, cfg) -> np.ndarray:
    """Re-orient a source tensor into the target's layout."""
    if w.ndim == 4 and w.shape != target.shape:
        # torch OIHW → flax HWIO
        w = np.transpose(w, (2, 3, 1, 0))
    if name == "fc.weight":
        d = cfg.embed_dim
        if w.shape[0] == d:          # raw torch [out, in]
            w = np.transpose(w, (1, 0))
        # permute input dim: torch flattens NCHW (c·h·w), flax NHWC (h·w·c).
        # The final iResNet map is input_size/16 per side (4 stride-2
        # stages), NOT a hardcoded 7 — cfg.input_size is configurable
        s = int(cfg.input_size) // 16
        in_dim = w.shape[0]
        if in_dim % (s * s):
            raise ValueError(
                f"fc.weight input dim {in_dim} is not divisible by the "
                f"{s}x{s} final map implied by input_size={cfg.input_size}")
        c = in_dim // (s * s)
        idx = np.arange(in_dim).reshape(c, s, s)     # torch order (c, h, w)
        perm = np.transpose(idx, (1, 2, 0)).reshape(-1)  # flax order (h, w, c)
        w = w[perm]
    return w


def arcface_required_names(cfg):
    return sorted(set(arcface_name_map(cfg).values()))


# ---------------------------------------------------------------------------
# CLIP ViT (open_clip visual tower layout)
# ---------------------------------------------------------------------------

def load_clip_torch(variables, cfg, src: Dict[str, np.ndarray],
                    strict: bool = True):
    """Fill our ClipViT variables from an open_clip visual-tower state dict
    (keys with or without the ``visual.`` prefix / converter ``src/``)."""
    clean: Dict[str, np.ndarray] = {}
    for k, v in src.items():
        if k.startswith("src/"):
            k = k[4:]
        if k.startswith("visual."):
            k = k[7:]
        clean[k] = np.asarray(v)
    src = clean

    out = _copy_tree(variables)
    params = out["params"]
    missing = []

    def take(name, transform=None):
        if name not in src:
            missing.append(name)
            return None
        w = src[name]
        return transform(w) if transform else w

    def put(tree_path, value, target):
        if value is None:
            return
        target_arr = np.asarray(target)
        if value.shape != target_arr.shape:
            raise ValueError(f"shape mismatch {tree_path}: "
                             f"{value.shape} vs {target_arr.shape}")
        _set_path(params, tree_path, value.astype(target_arr.dtype))

    w = cfg.width
    # torch conv [w, 3, p, p] or converter HWIO
    conv = take("conv1.weight",
                lambda t: np.transpose(t, (2, 3, 1, 0)) if t.shape[0] == w
                else t)
    put(("patch_embed", "kernel"), conv, params["patch_embed"]["kernel"])
    put(("class_token",), take("class_embedding",
                               lambda t: t.reshape(1, 1, -1)),
        params["class_token"])
    put(("pos_embed",), take("positional_embedding",
                             lambda t: t[None] if t.ndim == 2 else t),
        params["pos_embed"])
    for ln, tname in (("ln_pre", "ln_pre"), ("ln_post", "ln_post")):
        put((ln, "scale"), take(f"{tname}.weight"), params[ln]["scale"])
        put((ln, "bias"), take(f"{tname}.bias"), params[ln]["bias"])
    put(("proj",), take("proj"), params["proj"])

    for i in range(cfg.layers):
        b = f"block_{i}"
        t = f"transformer.resblocks.{i}"
        blk = params[b]
        put((b, "LayerNorm_0", "scale"), take(f"{t}.ln_1.weight"),
            blk["LayerNorm_0"]["scale"])
        put((b, "LayerNorm_0", "bias"), take(f"{t}.ln_1.bias"),
            blk["LayerNorm_0"]["bias"])
        put((b, "MHA_0", "Dense_0", "kernel"),
            take(f"{t}.attn.in_proj_weight", lambda x: np.transpose(x, (1, 0))),
            blk["MHA_0"]["Dense_0"]["kernel"])
        put((b, "MHA_0", "Dense_0", "bias"),
            take(f"{t}.attn.in_proj_bias"),
            blk["MHA_0"]["Dense_0"]["bias"])
        put((b, "MHA_0", "Dense_1", "kernel"),
            take(f"{t}.attn.out_proj.weight",
                 lambda x: np.transpose(x, (1, 0))),
            blk["MHA_0"]["Dense_1"]["kernel"])
        put((b, "MHA_0", "Dense_1", "bias"),
            take(f"{t}.attn.out_proj.bias"),
            blk["MHA_0"]["Dense_1"]["bias"])
        put((b, "LayerNorm_1", "scale"), take(f"{t}.ln_2.weight"),
            blk["LayerNorm_1"]["scale"])
        put((b, "LayerNorm_1", "bias"), take(f"{t}.ln_2.bias"),
            blk["LayerNorm_1"]["bias"])
        put((b, "Dense_0", "kernel"),
            take(f"{t}.mlp.c_fc.weight", lambda x: np.transpose(x, (1, 0))),
            blk["Dense_0"]["kernel"])
        put((b, "Dense_0", "bias"), take(f"{t}.mlp.c_fc.bias"),
            blk["Dense_0"]["bias"])
        put((b, "Dense_1", "kernel"),
            take(f"{t}.mlp.c_proj.weight", lambda x: np.transpose(x, (1, 0))),
            blk["Dense_1"]["kernel"])
        put((b, "Dense_1", "bias"), take(f"{t}.mlp.c_proj.bias"),
            blk["Dense_1"]["bias"])

    if strict and missing:
        raise KeyError(f"missing tensors in checkpoint: {missing[:8]}"
                       f"{'…' if len(missing) > 8 else ''}")
    out["params"] = params
    return out


# ---------------------------------------------------------------------------
# YOLOv8 (ultralytics layout)
# ---------------------------------------------------------------------------

# flax scope ← ultralytics model.model.{idx} for the yolov8 yaml graph
_YOLO_LAYER_MAP = [
    ("ConvSiLU_0", 0, "conv"), ("ConvSiLU_1", 1, "conv"),
    ("C2f_0", 2, "c2f"), ("ConvSiLU_2", 3, "conv"), ("C2f_1", 4, "c2f"),
    ("ConvSiLU_3", 5, "conv"), ("C2f_2", 6, "c2f"),
    ("ConvSiLU_4", 7, "conv"), ("C2f_3", 8, "c2f"), ("SPPF_0", 9, "sppf"),
    ("C2f_4", 12, "c2f"), ("C2f_5", 15, "c2f"),
    ("ConvSiLU_5", 16, "conv"), ("C2f_6", 18, "c2f"),
    ("ConvSiLU_6", 19, "conv"), ("C2f_7", 21, "c2f"),
]


def yolov8_name_map(cfg) -> Dict[Tuple[str, ...], str]:
    """flax (collection, scope-path, leaf) → ultralytics tensor name."""
    m: Dict[Tuple[str, ...], str] = {}

    def conv_silu(scope: str, t: str):
        m[("params", f"{scope}/Conv_0", "kernel")] = f"{t}.conv.weight"
        m[("params", f"{scope}/BatchNorm_0", "scale")] = f"{t}.bn.weight"
        m[("params", f"{scope}/BatchNorm_0", "bias")] = f"{t}.bn.bias"
        m[("batch_stats", f"{scope}/BatchNorm_0", "mean")] = \
            f"{t}.bn.running_mean"
        m[("batch_stats", f"{scope}/BatchNorm_0", "var")] = \
            f"{t}.bn.running_var"

    def c2f(scope: str, t: str, n: int):
        conv_silu(f"{scope}/ConvSiLU_0", f"{t}.cv1")
        for i in range(n):
            conv_silu(f"{scope}/Bottleneck_{i}/ConvSiLU_0", f"{t}.m.{i}.cv1")
            conv_silu(f"{scope}/Bottleneck_{i}/ConvSiLU_1", f"{t}.m.{i}.cv2")
        conv_silu(f"{scope}/ConvSiLU_1", f"{t}.cv2")

    d1, d2, d3, d4 = cfg.depth
    c2f_depths = {"C2f_0": d1, "C2f_1": d2, "C2f_2": d3, "C2f_3": d4,
                  "C2f_4": d1, "C2f_5": d1, "C2f_6": d1, "C2f_7": d1}
    for scope, idx, kind in _YOLO_LAYER_MAP:
        t = f"model.{idx}"
        if kind == "conv":
            conv_silu(scope, t)
        elif kind == "sppf":
            conv_silu(f"{scope}/ConvSiLU_0", f"{t}.cv1")
            conv_silu(f"{scope}/ConvSiLU_1", f"{t}.cv2")
        else:
            c2f(scope, t, c2f_depths[scope])

    # Detect head: per level l, box branch cv2.l.{0,1,2}, cls branch cv3,
    # and (pose/face models) landmark branch cv4. With a kpt head the flax
    # auto-numbering gains one Conv and two ConvSiLU per level.
    det = "model.22"
    has_kpt = bool(getattr(cfg, "kpt_shape", (0, 0))[0])
    convs_per_level = 3 if has_kpt else 2
    silus_per_level = 6 if has_kpt else 4
    for lvl in range(3):
        base = 7 + silus_per_level * lvl
        cbase = convs_per_level * lvl
        conv_silu(f"ConvSiLU_{base}", f"{det}.cv2.{lvl}.0")
        conv_silu(f"ConvSiLU_{base + 1}", f"{det}.cv2.{lvl}.1")
        m[("params", f"Conv_{cbase}", "kernel")] = f"{det}.cv2.{lvl}.2.weight"
        m[("params", f"Conv_{cbase}", "bias")] = f"{det}.cv2.{lvl}.2.bias"
        conv_silu(f"ConvSiLU_{base + 2}", f"{det}.cv3.{lvl}.0")
        conv_silu(f"ConvSiLU_{base + 3}", f"{det}.cv3.{lvl}.1")
        m[("params", f"Conv_{cbase + 1}", "kernel")] = \
            f"{det}.cv3.{lvl}.2.weight"
        m[("params", f"Conv_{cbase + 1}", "bias")] = \
            f"{det}.cv3.{lvl}.2.bias"
        if has_kpt:
            conv_silu(f"ConvSiLU_{base + 4}", f"{det}.cv4.{lvl}.0")
            conv_silu(f"ConvSiLU_{base + 5}", f"{det}.cv4.{lvl}.1")
            m[("params", f"Conv_{cbase + 2}", "kernel")] = \
                f"{det}.cv4.{lvl}.2.weight"
            m[("params", f"Conv_{cbase + 2}", "bias")] = \
                f"{det}.cv4.{lvl}.2.bias"
    return m


def load_yolov8_torch(variables, cfg, src: Dict[str, np.ndarray],
                      strict: bool = True):
    """Fill our YoloV8 variables from an ultralytics state dict (keys with
    or without 'model.model.' vs 'model.' prefixes; dfl weights skipped —
    our decode computes the DFL expectation functionally)."""
    clean = {}
    for k, v in src.items():
        if k.startswith("src/"):
            k = k[4:]
        if k.startswith("model.model."):
            k = k[len("model."):]
        clean[k] = np.asarray(v)
    src = clean

    out = _copy_tree(variables)
    name_map = yolov8_name_map(cfg)
    missing = []
    for path, torch_name in name_map.items():
        if torch_name not in src:
            missing.append(torch_name)
            continue
        w = src[torch_name]
        coll, scope, leaf = path[0], _flatten_scope(path[1]), path[2]
        full = (coll,) + scope + (leaf,)
        target = np.asarray(_get_path(out, full))
        if w.ndim == 4 and w.shape != target.shape:
            w = np.transpose(w, (2, 3, 1, 0))  # OIHW → HWIO
        if w.shape != target.shape:
            raise ValueError(f"shape mismatch {torch_name} -> {full}: "
                             f"{w.shape} vs {target.shape}")
        _set_path(out, full, w.astype(target.dtype))
    if strict and missing:
        raise KeyError(f"missing tensors in checkpoint: {missing[:8]}"
                       f"{'…' if len(missing) > 8 else ''}")
    return out


def yolov8_required_names(cfg):
    return sorted(set(yolov8_name_map(cfg).values()))


def load_checkpoint(path: str, kind: str, variables, cfg):
    """Load a checkpoint file into flax variables.

    Accepts either a flat flax-variable ``.npz`` (tools/weights.py format,
    detected by a ``params/...`` key) or a converted torch state dict
    (``src/<torch name>`` keys or raw torch names), mapped by ``kind``
    ('arcface' | 'clip' | 'yolov8')."""
    from ..tools.weights import load_npz_variables

    with np.load(path) as data:
        # decide the format from the key names BEFORE materializing any
        # tensors — the flax-layout case otherwise decompresses the whole
        # file twice (once here, once inside load_npz_variables)
        if any(k.startswith("params/") for k in data.files):
            return load_npz_variables(path)
        flat = {k: data[k] for k in data.files}
    loader = {"arcface": load_arcface_torch, "clip": load_clip_torch,
              "yolov8": load_yolov8_torch}[kind]
    return loader(variables, cfg, flat, strict=True)


# ---------------------------------------------------------------------------
# the inverse: flax variables → a torch state dict in the official names
# ---------------------------------------------------------------------------

def _clip_torch_names(cfg) -> Dict[Tuple[str, ...], Tuple[str, str]]:
    """flax params path → (open_clip visual-tower name, layout)."""
    m = {("patch_embed", "kernel"): ("conv1.weight", "conv"),
         ("class_token",): ("class_embedding", "flat"),
         ("pos_embed",): ("positional_embedding", "squeeze0"),
         ("proj",): ("proj", "")}
    for ln in ("ln_pre", "ln_post"):
        m[(ln, "scale")] = (f"{ln}.weight", "")
        m[(ln, "bias")] = (f"{ln}.bias", "")
    for i in range(cfg.layers):
        b, t = f"block_{i}", f"transformer.resblocks.{i}"
        for scope, name in ((("LayerNorm_0",), "ln_1"),
                            (("LayerNorm_1",), "ln_2")):
            m[(b, *scope, "scale")] = (f"{t}.{name}.weight", "")
            m[(b, *scope, "bias")] = (f"{t}.{name}.bias", "")
        for scope, name in ((("MHA_0", "Dense_0"), "attn.in_proj_"),
                            (("MHA_0", "Dense_1"), "attn.out_proj."),
                            (("Dense_0",), "mlp.c_fc."),
                            (("Dense_1",), "mlp.c_proj.")):
            m[(b, *scope, "kernel")] = (f"{t}.{name}weight", "dense")
            m[(b, *scope, "bias")] = (f"{t}.{name}bias", "")
    return m


def torch_state_dict(kind: str, variables, cfg) -> Dict[str, np.ndarray]:
    """Flax variables → the tensors of the official torch checkpoint
    (insightface iresnet for 'arcface', ultralytics for 'yolov8', the
    open_clip visual tower for 'clip'), in torch layouts (OIHW convs,
    [out, in] dense weights, ArcFace's fc input in torch's C·H·W order):
    the inverse of the name maps above, so ``load_*_torch`` of the result
    gives ``variables`` back. Writes checkpoints for tests and smoke runs
    without a download."""
    out: Dict[str, np.ndarray] = {}
    if kind == "clip":
        params = variables["params"]
        for path, (name, layout) in _clip_torch_names(cfg).items():
            w = np.asarray(_get_path(params, path), np.float32)
            if layout == "conv":
                w = np.transpose(w, (3, 2, 0, 1))
            elif layout == "dense":
                w = w.T
            elif layout == "flat":
                w = w.reshape(-1)
            elif layout == "squeeze0":
                w = w[0]
            out[name] = np.ascontiguousarray(w)
        return out
    name_map = {"arcface": arcface_name_map,
                "yolov8": yolov8_name_map}[kind](cfg)
    for path, torch_name in name_map.items():
        full = (path[0],) + _flatten_scope(path[1]) + (path[2],)
        w = np.asarray(_get_path(variables, full), np.float32)
        if w.ndim == 4:
            w = np.transpose(w, (3, 2, 0, 1))        # HWIO → OIHW
        elif kind == "arcface" and torch_name == "fc.weight":
            s = int(cfg.input_size) // 16
            c = w.shape[0] // (s * s)
            # flax rows in (h, w, c) order → torch (c, h, w), then [out, in]
            w = w.reshape(s, s, c, -1).transpose(2, 0, 1, 3)
            w = w.reshape(c * s * s, -1).T
        out[torch_name] = np.ascontiguousarray(w)
    return out
