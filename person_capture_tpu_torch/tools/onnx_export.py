"""Export the zoo's SCRFD / ArcFace weights (flax variables) to ONNX.

The reference CONSUMES insightface ONNX files (scrfd_*_bnkps.onnx,
w600k_r50.onnx — person_capture/face_embedder.py:55-83); this tool
PRODUCES files in the same layout from the bundled or a user's flax
weights, so

* the checkpoint-exact ONNX executor path (tools/onnx_exec +
  models/onnx_zoo, the ``--scrfd-weights foo.onnx`` CLI surface) gets an
  in-repo end-to-end fixture that does not depend on downloaded reference
  checkpoints, and
* users can hand a trained in-repo model to any ONNX runtime.

Graph layout matches what :class:`~..models.onnx_zoo.OnnxScrfdDetector`
expects from insightface graphs: input ``[N,3,S,S]`` normalized NCHW;
nine outputs grouped by kind (scores×3 post-sigmoid, bbox×3, kps×3, one
per stride 8/16/32), each ``[N, h*w*a, K]`` flattened in (h, w, anchor)
order — the same order ``models.scrfd.decode_level`` flattens NHWC maps.
ArcFace: ``[N,3,112,112]`` → ``[N, D]`` (raw, pre-normalization), ending
in the official iresnet's affine BatchNorm1d so
``onnx_zoo._infer_embed_dim`` reads D from the graph.

Writer subset: tools/onnx_lite (the `onnx` package is not a dependency).
Flax→ONNX mechanics: NHWC HWIO kernels transpose to OIHW; flax
``padding=k//2`` becomes symmetric ``pads``; ``upsample2x`` (nearest
repeat) becomes Resize(asymmetric, floor); flax GroupNorm decomposes to
Reshape/ReduceMean/Sub/Mul/Sqrt/Div (same element grouping in NCHW);
flax's NHWC ``reshape(n, -1)`` flatten becomes Transpose(0,2,3,1) →
Flatten so the Dense weights keep their element order.

Copied from ``person_capture_tpu/tools/onnx_export.py`` (numpy and
onnx_lite only); :func:`main` initialises a model without weights from the
port's seeded random init, read back as flax variables
(``models/bridge.flax_variables``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .onnx_lite import OnnxNode, write_onnx


class _G:
    """Tiny ONNX graph builder over onnx_lite's writer types."""

    def __init__(self):
        self.nodes: List[OnnxNode] = []
        self.inits: Dict[str, np.ndarray] = {}
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, arr: np.ndarray, hint: str = "w") -> str:
        n = self.name(hint)
        self.inits[n] = np.ascontiguousarray(arr)
        return n

    def node(self, op: str, inputs: Sequence[str], out: Optional[str] = None,
             **attrs) -> str:
        out = out or self.name(op.lower())
        self.nodes.append(OnnxNode(op, list(inputs), [out],
                                   name=self.name(op), attrs=dict(attrs)))
        return out

    # -- composite helpers (all NCHW) -----------------------------------
    def conv(self, x: str, kernel_hwio: np.ndarray,
             bias: Optional[np.ndarray] = None, stride: int = 1) -> str:
        k = np.transpose(np.asarray(kernel_hwio, np.float32), (3, 2, 0, 1))
        p = k.shape[2] // 2                       # flax padding=kernel//2
        ins = [x, self.init(k, "convw")]
        if bias is not None:
            ins.append(self.init(np.asarray(bias, np.float32), "convb"))
        return self.node("Conv", ins, strides=[stride, stride],
                         pads=[p, p, p, p])

    def bn(self, x: str, tree: Dict[str, Any], stats: Dict[str, Any],
           eps: float = 1e-5) -> str:
        f32 = lambda a: np.asarray(a, np.float32)
        return self.node("BatchNormalization", [
            x, self.init(f32(tree["scale"]), "bns"),
            self.init(f32(tree["bias"]), "bnb"),
            self.init(f32(stats["mean"]), "bnm"),
            self.init(f32(stats["var"]), "bnv")], epsilon=float(eps))

    def relu(self, x: str) -> str:
        return self.node("Relu", [x])

    def add(self, a: str, b: str) -> str:
        return self.node("Add", [a, b])

    def sigmoid(self, x: str) -> str:
        return self.node("Sigmoid", [x])

    def prelu(self, x: str, alpha: np.ndarray) -> str:
        slope = np.asarray(alpha, np.float32).reshape(-1, 1, 1)
        return self.node("PRelu", [x, self.init(slope, "prelu")])

    def resize2x(self, x: str) -> str:
        # upsample2x is a nearest repeat: asymmetric coords + floor
        scales = self.init(np.asarray([1.0, 1.0, 2.0, 2.0], np.float32),
                           "scales")
        return self.node("Resize", [x, "", scales], mode="nearest",
                         coordinate_transformation_mode="asymmetric",
                         nearest_mode="floor")

    def reshape(self, x: str, shape: Sequence[int]) -> str:
        s = self.init(np.asarray(shape, np.int64), "shape")
        return self.node("Reshape", [x, s])

    def groupnorm(self, x: str, tree: Dict[str, Any], groups: int, c: int,
                  h: int, w: int, eps: float = 1e-6) -> str:
        """flax nn.GroupNorm: normalize within each channel group over
        (group-channels, H, W), then per-channel affine."""
        r = self.reshape(x, [0, groups, -1])
        m = self.node("ReduceMean", [r], axes=[2], keepdims=1)
        d = self.node("Sub", [r, m])
        v = self.node("ReduceMean", [self.node("Mul", [d, d])],
                      axes=[2], keepdims=1)
        std = self.node("Sqrt", [self.node(
            "Add", [v, self.init(np.float32(eps), "gneps")])])
        n = self.node("Div", [d, std])
        out = self.reshape(n, [0, c, h, w])
        out = self.node("Mul", [out, self.init(
            np.asarray(tree["scale"], np.float32).reshape(c, 1, 1), "gns")])
        return self.node("Add", [out, self.init(
            np.asarray(tree["bias"], np.float32).reshape(c, 1, 1), "gnb")])

    def convbn(self, x: str, tree: Dict[str, Any], stats: Dict[str, Any],
               stride: int = 1, act: bool = True) -> str:
        y = self.conv(x, tree["Conv_0"]["kernel"], stride=stride)
        y = self.bn(y, tree["BatchNorm_0"], stats["BatchNorm_0"])
        return self.relu(y) if act else y


def export_scrfd(path: str, cfg, variables, det_size: int) -> None:
    """Write an insightface-layout SCRFD ONNX graph from flax variables
    (``models.scrfd.SCRFD``). ``det_size`` fixes the spatial shapes (the
    adapter letterboxes to one size anyway); batch stays dynamic."""
    deepest = max(cfg.strides)
    if det_size % deepest:
        # the stride-2 conv chain ceil-divides odd sizes while the head
        # Reshapes use floor(det_size/stride): a non-divisible size would
        # write an internally inconsistent graph that every runtime
        # rejects at execution (same rule as models.scrfd.init_scrfd)
        raise ValueError(
            f"SCRFD export size must be a multiple of {deepest}, "
            f"got {det_size}")
    P = variables["params"]
    B = variables["batch_stats"]
    g = _G()
    x = "input.1"

    # backbone ----------------------------------------------------------
    bb, bbs = P["_Backbone_0"], B["_Backbone_0"]
    h = g.convbn(x, bb["ConvBN_0"], bbs["ConvBN_0"], stride=2)
    feats = []
    bi_global = 0
    for si, (ch, nblocks) in enumerate(zip(cfg.stage_channels,
                                           cfg.stage_blocks)):
        for bi in range(nblocks):
            stride = 2 if bi == 0 else 1
            blk = bb[f"ResBasicBlock_{bi_global}"]
            bst = bbs[f"ResBasicBlock_{bi_global}"]
            y = g.convbn(h, blk["ConvBN_0"], bst["ConvBN_0"], stride=stride)
            y = g.convbn(y, blk["ConvBN_1"], bst["ConvBN_1"], act=False)
            if "ConvBN_2" in blk:
                idn = g.convbn(h, blk["ConvBN_2"], bst["ConvBN_2"],
                               stride=stride, act=False)
            else:
                idn = h
            h = g.relu(g.add(y, idn))
            bi_global += 1
        feats.append(h)
    c3, c4, c5 = feats[1], feats[2], feats[3]

    # PA-FPN (submodule creation order fixes the ConvBN indices) --------
    fp, fps = P["_PAFPN_0"], B["_PAFPN_0"]
    cv = lambda i, x_, st=1, act=False: g.convbn(
        x_, fp[f"ConvBN_{i}"], fps[f"ConvBN_{i}"], stride=st, act=act)
    p5 = cv(0, c5)
    p4 = g.add(cv(1, c4), g.resize2x(p5))
    p3 = g.add(cv(2, c3), g.resize2x(p4))
    p3 = cv(3, p3, act=True)
    p4 = cv(4, p4, act=True)
    p5 = cv(5, p5, act=True)
    n4 = g.add(p4, cv(6, p3, st=2))
    n5 = g.add(p5, cv(7, n4, st=2))
    n4 = cv(8, n4, act=True)
    n5 = cv(9, n5, act=True)

    # shared head per level --------------------------------------------
    hd = P["_Head_0"]
    a = cfg.num_anchors
    fpn = cfg.fpn_channels
    groups = min(16, fpn)
    score_outs, bbox_outs, kps_outs = [], [], []
    for level, (feat, stride) in enumerate(zip((p3, n4, n5), cfg.strides)):
        side = det_size // stride
        hwa = side * side * a
        t = feat
        for si_ in range(cfg.head_stacks):
            t = g.conv(t, hd[f"Conv_{si_}"]["kernel"])
            t = g.groupnorm(t, hd[f"GroupNorm_{si_}"], groups, fpn,
                            side, side)
            t = g.relu(t)

        def head_out(conv_idx: int, k: int,
                     out_name: Optional[str] = None) -> str:
            c_ = hd[f"Conv_{conv_idx}"]
            y = g.conv(t, c_["kernel"], bias=c_["bias"])
            # NCHW [N, a*K, h, w] → (h, w, anchor)-ordered [N, h*w*a, K],
            # matching models.scrfd.decode_level's NHWC flatten
            y = g.node("Transpose", [y], perm=[0, 2, 3, 1])
            shape = g.init(np.asarray([0, hwa, k], np.int64), "shape")
            return g.node("Reshape", [y, shape], out=out_name)

        s = head_out(cfg.head_stacks, 1)
        score_outs.append(g.node("Sigmoid", [s], out=f"score_{stride}"))
        bbox_outs.append(head_out(cfg.head_stacks + 1, 4, f"bbox_{stride}"))
        kps_outs.append(head_out(cfg.head_stacks + 2, 10, f"kps_{stride}"))

    write_onnx(path, nodes=g.nodes, initializers=g.inits,
               inputs={x: (None, 3, det_size, det_size)},
               outputs=score_outs + bbox_outs + kps_outs, opset=11)


def export_arcface(path: str, cfg, variables) -> None:
    """Write a w600k-layout ArcFace ONNX graph from flax variables
    (``models.arcface.IResNet``): ``[N,3,112,112]`` → ``[N, D]`` raw
    embedding ending in the official iresnet's affine BatchNorm1d."""
    P = variables["params"]
    B = variables["batch_stats"]
    g = _G()
    x = "input.1"

    h = g.conv(x, P["Conv_0"]["kernel"])
    h = g.bn(h, P["BatchNorm_0"], B["BatchNorm_0"])
    h = g.prelu(h, P["PReLU_0"]["alpha"])
    bi_global = 0
    for ch, nblocks in zip(cfg.stage_channels, cfg.stage_blocks):
        for bi in range(nblocks):
            stride = 2 if bi == 0 else 1
            blk = P[f"IBasicBlock_{bi_global}"]
            bst = B[f"IBasicBlock_{bi_global}"]
            y = g.bn(h, blk["BatchNorm_0"], bst["BatchNorm_0"])
            y = g.conv(y, blk["Conv_0"]["kernel"])
            y = g.bn(y, blk["BatchNorm_1"], bst["BatchNorm_1"])
            y = g.prelu(y, blk["PReLU_0"]["alpha"])
            y = g.conv(y, blk["Conv_1"]["kernel"], stride=stride)
            y = g.bn(y, blk["BatchNorm_2"], bst["BatchNorm_2"])
            if "Conv_2" in blk:
                idn = g.conv(h, blk["Conv_2"]["kernel"], stride=stride)
                idn = g.bn(idn, blk["BatchNorm_3"], bst["BatchNorm_3"])
            else:
                idn = h
            h = g.add(y, idn)
            bi_global += 1
    h = g.bn(h, P["BatchNorm_1"], B["BatchNorm_1"])
    # flax flattens NHWC (H, W, C)-ordered: transpose before Flatten so
    # the Dense weights keep their element order
    h = g.node("Transpose", [h], perm=[0, 2, 3, 1])
    h = g.node("Flatten", [h], axis=1)
    dense = P["Dense_0"]
    h = g.node("Gemm", [h, g.init(np.asarray(dense["kernel"], np.float32),
                                  "fcw"),
                        g.init(np.asarray(dense["bias"], np.float32),
                               "fcb")], transB=0)
    # final affine BatchNorm1d: a real BatchNormalization node so
    # onnx_zoo._infer_embed_dim reads D from the graph
    g.node("BatchNormalization", [
        h, g.init(np.asarray(P["BatchNorm_2"]["scale"], np.float32), "bns"),
        g.init(np.asarray(P["BatchNorm_2"]["bias"], np.float32), "bnb"),
        g.init(np.asarray(B["BatchNorm_2"]["mean"], np.float32), "bnm"),
        g.init(np.asarray(B["BatchNorm_2"]["var"], np.float32), "bnv")],
        out="683", epsilon=1e-5)

    write_onnx(path, nodes=g.nodes, initializers=g.inits,
               inputs={x: (None, 3, cfg.input_size, cfg.input_size)},
               outputs=["683"], opset=11)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m person_capture_tpu_torch.tools.onnx_export",
        description="export bundled/npz flax weights to ONNX")
    ap.add_argument("--model", required=True,
                    help="zoo model name (e.g. scrfd_2.5g, scrfd_tiny, "
                         "arcface_synth, arcface_tiny, w600k_r50)")
    ap.add_argument("--weights", default="auto",
                    help="weights spec (auto = bundled; or an .npz path; "
                         "random = seeded random init)")
    ap.add_argument("--out", required=True, help="output .onnx path")
    ap.add_argument("--det-size", type=int, default=640,
                    help="SCRFD spatial export size (ignored for ArcFace)")
    args = ap.parse_args(argv)

    from ..models.bridge import flax_variables
    from ..models.zoo import resolve_weights
    from ..pipeline.backends import _random_init

    if args.model.startswith("scrfd"):
        from ..models import scrfd as SD

        cfg = SD.CONFIGS[args.model]
        variables = resolve_weights(args.weights, args.model)
        if variables is None:
            model = SD.SCRFD(cfg)
            _random_init(model, 0)
            variables = flax_variables(model)
        export_scrfd(args.out, cfg, variables, args.det_size)
    else:
        from ..models import arcface as AF

        cfg = AF.CONFIGS[args.model]
        variables = resolve_weights(args.weights, args.model)
        if variables is None:
            model = AF.IResNet(cfg)
            _random_init(model, 0)
            variables = flax_variables(model)
        export_arcface(args.out, cfg, variables)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
