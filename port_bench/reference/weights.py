"""Flax checkpoints (``.npz``, one array per ``/``-joined leaf) → the
reference modules' ``state_dict``s, read with numpy alone.

A frozen copy of the mapping the port uses (conv kernel HWIO → OIHW, Dense
kernel (in, out) → (out, in), BatchNorm scale/bias + mean/var, GroupNorm and
LayerNorm scale/bias, channelwise PReLU alpha). Strict both ways: a leaf the
walk does not consume raises, and so does a tensor of the module that no
leaf fills.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    root: Dict = {}
    for path, arr in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def load_npz(path: str) -> Dict:
    """A flax checkpoint as a nested dict of float32 numpy arrays."""
    with np.load(path) as data:
        return unflatten_tree({k: np.asarray(data[k], np.float32)
                               for k in data.files})


class _Leaves:
    def __init__(self, variables: Mapping):
        self.flat = dict(flatten_tree(variables))
        self.sd: Dict[str, torch.Tensor] = {}

    def link(self, name: str, path: str, perm=None) -> None:
        try:
            arr = np.asarray(self.flat.pop(path), np.float32)
        except KeyError:
            raise KeyError(f"checkpoint has no leaf {path!r}") from None
        if perm is not None:
            arr = arr.transpose(perm)
        self.sd[name] = torch.from_numpy(np.array(arr))

    def conv(self, name, scope, bias=False):
        self.link(f"{name}.weight", f"params/{scope}/kernel", (3, 2, 0, 1))
        if bias:
            self.link(f"{name}.bias", f"params/{scope}/bias")

    def dense(self, name, scope):
        self.link(f"{name}.weight", f"params/{scope}/kernel", (1, 0))
        self.link(f"{name}.bias", f"params/{scope}/bias")

    def bn(self, name, scope):
        self.gn(name, scope)
        self.link(f"{name}.running_mean", f"batch_stats/{scope}/mean")
        self.link(f"{name}.running_var", f"batch_stats/{scope}/var")

    def gn(self, name, scope):
        self.link(f"{name}.weight", f"params/{scope}/scale")
        self.link(f"{name}.bias", f"params/{scope}/bias")

    def prelu(self, name, scope):
        self.link(f"{name}.alpha", f"params/{scope}/alpha")

    def convbn(self, name, scope):
        self.conv(f"{name}.conv", f"{scope}/Conv_0")
        self.bn(f"{name}.bn", f"{scope}/BatchNorm_0")

    def finish(self, module):
        if self.flat:
            raise KeyError(f"leaves not used by {type(module).__name__}: "
                           f"{sorted(self.flat)[:8]}")
        for k, v in module.state_dict().items():
            if k.endswith("num_batches_tracked"):
                self.sd.setdefault(k, v)
        module.load_state_dict(self.sd, strict=True)
        return module


def load_scrfd(model, variables):
    lv, cfg = _Leaves(variables), model.cfg
    lv.convbn("backbone.stem", "_Backbone_0/ConvBN_0")
    for i, blk in enumerate(model.backbone.blocks):
        scope = f"_Backbone_0/ResBasicBlock_{i}"
        lv.convbn(f"backbone.blocks.{i}.conv1", f"{scope}/ConvBN_0")
        lv.convbn(f"backbone.blocks.{i}.conv2", f"{scope}/ConvBN_1")
        if blk.down is not None:
            lv.convbn(f"backbone.blocks.{i}.down", f"{scope}/ConvBN_2")
    for i, name in enumerate(("lat5", "lat4", "lat3", "smooth3", "smooth4",
                              "smooth5", "down3", "down4", "out4", "out5")):
        lv.convbn(f"fpn.{name}", f"_PAFPN_0/ConvBN_{i}")
    hs = cfg.head_stacks
    for i in range(hs):
        lv.conv(f"head.convs.{i}", f"_Head_0/Conv_{i}")
        lv.gn(f"head.norms.{i}", f"_Head_0/GroupNorm_{i}")
    for j, name in enumerate(("cls", "bbox", "kps")):
        lv.conv(f"head.{name}", f"_Head_0/Conv_{hs + j}", bias=True)
    return lv.finish(model)


def load_arcface(model, variables):
    lv = _Leaves(variables)
    lv.conv("conv1", "Conv_0")
    lv.bn("bn1", "BatchNorm_0")
    lv.prelu("prelu", "PReLU_0")
    for i, blk in enumerate(model.blocks):
        scope, p = f"IBasicBlock_{i}", f"blocks.{i}"
        lv.bn(f"{p}.bn1", f"{scope}/BatchNorm_0")
        lv.conv(f"{p}.conv1", f"{scope}/Conv_0")
        lv.bn(f"{p}.bn2", f"{scope}/BatchNorm_1")
        lv.prelu(f"{p}.prelu", f"{scope}/PReLU_0")
        lv.conv(f"{p}.conv2", f"{scope}/Conv_1")
        lv.bn(f"{p}.bn3", f"{scope}/BatchNorm_2")
        if blk.down is not None:
            lv.conv(f"{p}.down.0", f"{scope}/Conv_2")
            lv.bn(f"{p}.down.1", f"{scope}/BatchNorm_3")
    lv.bn("bn2", "BatchNorm_1")
    lv.dense("fc", "Dense_0")
    lv.bn("features", "BatchNorm_2")
    return lv.finish(model)


def load_clip(model, variables):
    lv = _Leaves(variables)
    lv.conv("patch_embed", "patch_embed")
    for name in ("class_token", "pos_embed", "proj"):
        lv.link(name, f"params/{name}")
    lv.gn("ln_pre", "ln_pre")
    for i in range(len(model.blocks)):
        p, scope = f"blocks.{i}", f"block_{i}"
        lv.gn(f"{p}.ln1", f"{scope}/LayerNorm_0")
        lv.dense(f"{p}.attn.qkv", f"{scope}/MHA_0/Dense_0")
        lv.dense(f"{p}.attn.out", f"{scope}/MHA_0/Dense_1")
        lv.gn(f"{p}.ln2", f"{scope}/LayerNorm_1")
        lv.dense(f"{p}.fc", f"{scope}/Dense_0")
        lv.dense(f"{p}.proj", f"{scope}/Dense_1")
    lv.gn("ln_post", "ln_post")
    return lv.finish(model)


def load_yolov8(model, variables):
    lv = _Leaves(variables)
    counts: Dict[str, int] = {}

    def scope(kind):
        i = counts.get(kind, 0)
        counts[kind] = i + 1
        return f"{kind}_{i}"

    def convsilu(name, sc):
        lv.conv(f"{name}.conv", f"{sc}/Conv_0")
        lv.bn(f"{name}.bn", f"{sc}/BatchNorm_0")

    def c2f(name):
        sc = scope("C2f")
        convsilu(f"{name}.cv1", f"{sc}/ConvSiLU_0")
        for i in range(len(getattr(model, name).m)):
            for j in (1, 2):
                convsilu(f"{name}.m.{i}.cv{j}",
                         f"{sc}/Bottleneck_{i}/ConvSiLU_{j - 1}")
        convsilu(f"{name}.cv2", f"{sc}/ConvSiLU_1")

    for name in ("stem", "down1", "down2", "down3", "down4", "bottom_down4",
                 "bottom_down5"):
        convsilu(name, scope("ConvSiLU"))
    for name in ("stage1", "stage2", "stage3", "stage4", "top4", "top3",
                 "bottom4", "bottom5"):
        c2f(name)
    convsilu("sppf.cv1", "SPPF_0/ConvSiLU_0")
    convsilu("sppf.cv2", "SPPF_0/ConvSiLU_1")
    for lvl, head in enumerate(model.heads):
        for branch in ("box", "cls", "kps"):
            if getattr(head, branch) is None:
                continue
            p = f"heads.{lvl}.{branch}"
            convsilu(f"{p}.0", scope("ConvSiLU"))
            convsilu(f"{p}.1", scope("ConvSiLU"))
            lv.conv(f"{p}.2", scope("Conv"), bias=True)
    return lv.finish(model)
