"""Flax checkpoints → the port's ``state_dict``s.

The JAX package's weights are flax variable trees (read as numpy from the
bundled ``.npz``; :func:`..tools.weights.load_npz_variables`). This module
maps every leaf onto the torch modules of :mod:`.scrfd`, :mod:`.arcface`,
:mod:`.yolov8`, :mod:`.clip_vit` and :mod:`.siglip`:

  * conv kernel HWIO → OIHW; Dense kernel (in, out) → (out, in);
  * BatchNorm ``params/scale,bias`` + ``batch_stats/mean,var`` → weight,
    bias, running_mean, running_var (eps lives on the modules: 1e-5 for
    SCRFD and ArcFace, 1e-3 for YOLOv8);
  * GroupNorm and LayerNorm ``scale,bias`` → weight, bias (``min(16, C)``
    groups; LayerNorm ε 1e-6 on the CLIP modules);
  * channelwise PReLU ``alpha``.

It is strict both ways: a leaf the mapping does not consume raises, and so
does a parameter or buffer of the module that no leaf fills
(``load_state_dict(strict=True)``). :func:`flax_variables` runs the same
walk backwards, from a module to flax variables.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..tools.weights import flatten_tree, unflatten_tree


class _Leaves:
    """Flat ``'/'``-joined flax leaves, consumed exactly once each."""

    def __init__(self, variables: Mapping):
        self.flat: Dict[str, np.ndarray] = flatten_tree(variables)
        self.sd: Dict[str, torch.Tensor] = {}

    def take(self, path: str) -> np.ndarray:
        """Flax leaf ``path`` as float32, consumed."""
        try:
            return np.asarray(self.flat.pop(path), np.float32)
        except KeyError:
            raise KeyError(f"checkpoint has no leaf {path!r}") from None

    def put(self, name: str, arr: np.ndarray) -> None:
        self.sd[name] = torch.from_numpy(np.array(arr))  # a writable copy

    def link(self, name: str, path: str, perm=None) -> None:
        """Module tensor ``name`` ← flax leaf ``path``, its axes permuted by
        ``perm`` (flax → torch layout)."""
        arr = self.take(path)
        self.put(name, arr if perm is None else arr.transpose(perm))

    def conv(self, name: str, scope: str, bias: bool = False) -> None:
        self.link(f"{name}.weight", f"params/{scope}/kernel", (3, 2, 0, 1))
        if bias:
            self.link(f"{name}.bias", f"params/{scope}/bias")

    def dense(self, name: str, scope: str) -> None:
        self.link(f"{name}.weight", f"params/{scope}/kernel", (1, 0))
        self.link(f"{name}.bias", f"params/{scope}/bias")

    def bn(self, name: str, scope: str) -> None:
        self.gn(name, scope)
        self.link(f"{name}.running_mean", f"batch_stats/{scope}/mean")
        self.link(f"{name}.running_var", f"batch_stats/{scope}/var")

    def gn(self, name: str, scope: str) -> None:
        self.link(f"{name}.weight", f"params/{scope}/scale")
        self.link(f"{name}.bias", f"params/{scope}/bias")

    def prelu(self, name: str, scope: str) -> None:
        self.link(f"{name}.alpha", f"params/{scope}/alpha")

    def convbn(self, name: str, scope: str) -> None:
        self.conv(f"{name}.conv", f"{scope}/Conv_0")
        self.bn(f"{name}.bn", f"{scope}/BatchNorm_0")

    def finish(self, module: torch.nn.Module) -> torch.nn.Module:
        if self.flat:
            extra = sorted(self.flat)
            raise KeyError(f"checkpoint leaves not used by "
                           f"{type(module).__name__}: {extra[:8]}"
                           f"{'…' if len(extra) > 8 else ''}")
        # BatchNorm's num_batches_tracked counters are not weights
        for k, v in module.state_dict().items():
            if k.endswith("num_batches_tracked"):
                self.sd.setdefault(k, v)
        module.load_state_dict(self.sd, strict=True)
        return module


class _Export(_Leaves):
    """The same walk run backwards: each tensor of a module becomes its
    flax leaf (torch → flax layout), so :func:`flax_variables` names and
    shapes exactly the leaves the matching ``load_*`` consumes. Given
    ``tensors`` (one per parameter name) in place of the module's own, it
    exports those, and leaves out the names they lack (the statistics)."""

    def __init__(self, module: torch.nn.Module, tensors=None):
        self.sd = module.state_dict() if tensors is None else tensors
        self.flat = {}

    def link(self, name: str, path: str, perm=None) -> None:
        if name not in self.sd and not path.startswith("params/"):
            return
        arr = self.sd[name].detach().float().cpu().numpy()
        # a copy: a CPU tensor's numpy() shares the module's storage
        self.flat[path] = np.array(arr if perm is None else
                                   arr.transpose(np.argsort(perm)))

    def finish(self, module: torch.nn.Module) -> Dict:
        return unflatten_tree(self.flat)


def _scrfd(lv: _Leaves, model):
    """The walk over a :class:`..models.scrfd.SCRFD`'s tensors."""
    cfg = model.cfg
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


def _arcface(lv: _Leaves, model):
    """The walk over a :class:`..models.arcface.IResNet`'s tensors."""
    lv.conv("conv1", "Conv_0")
    lv.bn("bn1", "BatchNorm_0")
    lv.prelu("prelu", "PReLU_0")
    for i, blk in enumerate(model.blocks):
        scope = f"IBasicBlock_{i}"
        p = f"blocks.{i}"
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


def _clip(lv: _Leaves, model):
    """The walk over a :class:`..models.clip_vit.ClipViT`'s tensors.

    ``class_token``, ``pos_embed`` and ``proj`` map by name; in each
    ``block_{i}`` flax counts names per type in creation order:
    ``LayerNorm_0``, ``MHA_0`` (``Dense_0`` qkv, ``Dense_1`` out),
    ``LayerNorm_1``, then ``Dense_0`` (fc) and ``Dense_1`` (proj)."""
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


def _siglip_heads(lv: _Leaves, name: str, scope: str, parts) -> None:
    """big_vision's ``DenseGeneral`` projections ``parts`` of attention
    ``scope`` (kernel ``[W, heads, d]``, bias ``[heads, d]``) → one
    ``Linear`` ``name``, their outputs stacked in that order."""
    kernels = [lv.take(f"params/{scope}/{p}/kernel") for p in parts]
    lv.put(f"{name}.weight", np.concatenate(
        [k.reshape(k.shape[0], -1).T for k in kernels]))
    lv.put(f"{name}.bias", np.concatenate(
        [lv.take(f"params/{scope}/{p}/bias").reshape(-1) for p in parts]))


def _siglip_attn_out(lv: _Leaves, name: str, scope: str) -> None:
    kernel = lv.take(f"params/{scope}/out/kernel")      # [heads, d, W]
    lv.put(f"{name}.weight", kernel.reshape(-1, kernel.shape[-1]).T)
    lv.link(f"{name}.bias", f"params/{scope}/out/bias")


def _siglip(lv: _Leaves, model):
    """The walk over a :class:`..models.siglip.SiglipViT`'s tensors, from
    big_vision's layout of the tower (a SigLIP checkpoint's ``img``
    subtree, unscanned): ``embedding`` (conv with bias),
    ``pos_embedding``, ``Transformer/encoderblock_{i}`` (``LayerNorm_0``,
    ``MultiHeadDotProductAttention_0`` with ``query``/``key``/``value``/
    ``out``, ``LayerNorm_1``, ``MlpBlock_0/Dense_{0,1}``),
    ``Transformer/encoder_norm`` and ``MAPHead_0`` (``probe``, its
    attention, ``LayerNorm_0``, ``MlpBlock_0``)."""
    lv.conv("patch_embed", "embedding", bias=True)
    lv.link("pos_embed", "params/pos_embedding")
    for i in range(len(model.blocks)):
        p, scope = f"blocks.{i}", f"Transformer/encoderblock_{i}"
        att = f"{scope}/MultiHeadDotProductAttention_0"
        lv.gn(f"{p}.ln1", f"{scope}/LayerNorm_0")
        _siglip_heads(lv, f"{p}.attn.qkv", att, ("query", "key", "value"))
        _siglip_attn_out(lv, f"{p}.attn.out", att)
        lv.gn(f"{p}.ln2", f"{scope}/LayerNorm_1")
        lv.dense(f"{p}.mlp.fc1", f"{scope}/MlpBlock_0/Dense_0")
        lv.dense(f"{p}.mlp.fc2", f"{scope}/MlpBlock_0/Dense_1")
    lv.gn("ln_post", "Transformer/encoder_norm")
    att = "MAPHead_0/MultiHeadDotProductAttention_0"
    lv.link("head.probe", "params/MAPHead_0/probe")
    _siglip_heads(lv, "head.q", att, ("query",))
    _siglip_heads(lv, "head.kv", att, ("key", "value"))
    _siglip_attn_out(lv, "head.out", att)
    lv.gn("head.ln", "MAPHead_0/LayerNorm_0")
    lv.dense("head.mlp.fc1", "MAPHead_0/MlpBlock_0/Dense_0")
    lv.dense("head.mlp.fc2", "MAPHead_0/MlpBlock_0/Dense_1")
    return lv.finish(model)


def _yolov8(lv: _Leaves, model):
    """The walk over a :class:`..models.yolov8.YoloV8`'s tensors.

    Flax names submodules per type in creation order: the backbone's and
    neck's ``ConvSiLU_n`` (each PAN ``C2f`` is created before the strided
    conv that feeds it), ``C2f_n``, ``SPPF_0``, then per head level box
    ConvSiLU ×2 + ``Conv``, cls ConvSiLU ×2 + ``Conv`` and, for a pose head,
    kps ConvSiLU ×2 + ``Conv``."""
    counts: Dict[str, int] = {}

    def scope(kind: str) -> str:
        i = counts.get(kind, 0)
        counts[kind] = i + 1
        return f"{kind}_{i}"

    def convsilu(name: str, sc: str) -> None:
        lv.conv(f"{name}.conv", f"{sc}/Conv_0")
        lv.bn(f"{name}.bn", f"{sc}/BatchNorm_0")

    def c2f(name: str) -> None:
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


def load_scrfd(model, variables: Mapping):
    """Fill a :class:`..models.scrfd.SCRFD` from flax variables."""
    return _scrfd(_Leaves(variables), model)


def load_arcface(model, variables: Mapping):
    """Fill a :class:`..models.arcface.IResNet` from flax variables."""
    return _arcface(_Leaves(variables), model)


def load_clip(model, variables: Mapping):
    """Fill a :class:`..models.clip_vit.ClipViT` from flax variables."""
    return _clip(_Leaves(variables), model)


def load_siglip(model, variables: Mapping):
    """Fill a :class:`..models.siglip.SiglipViT` from flax variables in
    big_vision's layout."""
    return _siglip(_Leaves(variables), model)


def load_yolov8(model, variables: Mapping):
    """Fill a :class:`..models.yolov8.YoloV8` from flax variables."""
    return _yolov8(_Leaves(variables), model)


def _walk(model):
    from .arcface import IResNet
    from .clip_vit import ClipViT
    from .scrfd import SCRFD
    from .yolov8 import YoloV8

    return {SCRFD: _scrfd, IResNet: _arcface, ClipViT: _clip,
            YoloV8: _yolov8}[type(model)]


def flax_variables(model) -> Dict:
    """A model's weights as flax variables (numpy float32, nested
    ``params``/``batch_stats``): the inverse of its ``load_*``, so
    ``load_*(fresh_model, flax_variables(model))`` reproduces ``model``.
    It names and shapes every leaf the JAX package's module has, which
    makes it the template that :mod:`.loaders` fills from torch
    checkpoints."""
    return _walk(model)(_Export(model), model)


def flax_params(model, tensors: Mapping[str, torch.Tensor]) -> Dict:
    """One tensor per parameter of ``model`` (its gradients, or an
    optimizer's moments), keyed by parameter name, as the flax ``params``
    tree of the same leaves: ``{"params": {...}}`` in flax layout, numpy
    float32. A parameter missing from ``tensors`` raises ``KeyError``."""
    return _walk(model)(_Export(model, tensors), model)
