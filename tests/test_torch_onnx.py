"""The port's ONNX path against the JAX package's: every op of the
interpreter's table on seeded inputs, the protobuf reader and writer, the
exporter's bytes, and the SCRFD / ArcFace adapters on graphs the JAX
exporter writes from the bundled ``scrfd_tiny`` / ``arcface_synth`` weights.

Tolerances: op outputs within 1e-5 (absolute and relative, fp32; integer and
boolean outputs equal), the same shapes; detections slot for slot (same mask
and scores within 1e-5, boxes and landmarks within 1e-3 px); embeddings at a
cosine distance of at most 1e-4; exported files byte for byte.
"""

import filecmp

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.tools import onnx_exec as JX  # noqa: E402
from person_capture_tpu.tools import onnx_export as JE  # noqa: E402
from person_capture_tpu.tools import onnx_lite as JL  # noqa: E402
from person_capture_tpu_torch.tools import onnx_exec as TX  # noqa: E402
from person_capture_tpu_torch.tools import onnx_export as TE  # noqa: E402
from person_capture_tpu_torch.tools import onnx_lite as TL  # noqa: E402

RNG = np.random.default_rng(0)


def _f(*shape, lo=None):
    x = RNG.normal(size=shape).astype(np.float32)
    return np.abs(x) + lo if lo is not None else x


def _i(*shape, lo=-5, hi=6):
    return RNG.integers(lo, hi, shape).astype(np.int64)


def D(a):
    """A device value: a jnp array on the JAX side, a tensor on the port's."""
    return ("d", a)


def H(a):
    """A host constant: the same numpy value on both sides."""
    return ("h", np.asarray(a))


X4 = _f(2, 4, 7, 9)
XP = _f(1, 4, 11, 13)
B1 = RNG.random((2, 4, 7, 9)) > 0.5
B2 = RNG.random((2, 4, 7, 9)) > 0.5

# (id, op, attrs, inputs, outputs)
CASES = [
    ("Identity", "Identity", {}, [D(X4)], 1),
    ("Dropout", "Dropout", {}, [D(X4)], 2),
    ("Cast_f2i", "Cast", {"to": 6}, [D(X4 * 3)], 1),
    ("Cast_i2f", "Cast", {"to": 1}, [D(_i(3, 4).astype(np.int32))], 1),
    ("Shape", "Shape", {"start": 1}, [D(X4)], 1),
    ("Size", "Size", {}, [D(X4)], 1),
    ("Gather_neg", "Gather", {"axis": 1}, [D(X4), H([-1, 0, 2])], 1),
    ("Gather_scalar", "Gather", {"axis": 2}, [D(X4), H(np.int64(3))], 1),
    ("Gather_host", "Gather", {"axis": 0}, [H([4, 5, 6]), H([-1])], 1),
    ("Squeeze_attr", "Squeeze", {"axes": [1]}, [D(_f(2, 1, 3))], 1),
    ("Squeeze_input", "Squeeze", {}, [D(_f(2, 1, 3)), H([-2])], 1),
    ("Squeeze_all", "Squeeze", {}, [D(_f(1, 3, 1))], 1),
    ("Unsqueeze", "Unsqueeze", {"axes": [0, -1]}, [D(_f(2, 3))], 1),
    ("Unsqueeze_host", "Unsqueeze", {}, [H([2, 3]), H([0])], 1),
    ("Concat", "Concat", {"axis": 1}, [D(X4), D(_f(2, 3, 7, 9))], 1),
    ("Concat_host", "Concat", {"axis": 0}, [H([1, 2]), H(np.int64(3))], 1),
    ("Reshape", "Reshape", {}, [D(X4), H([0, -1, 9])], 1),
    ("Flatten", "Flatten", {"axis": 2}, [D(X4)], 1),
    ("Transpose", "Transpose", {"perm": [0, 2, 3, 1]}, [D(X4)], 1),
    ("Transpose_default", "Transpose", {}, [D(X4)], 1),
    ("Expand", "Expand", {}, [D(_f(3, 1)), H([2, 3, 4])], 1),
    ("Tile", "Tile", {}, [D(_f(2, 3)), H([2, 1])], 1),
    ("Slice_negative_steps", "Slice", {},
     [D(X4), H([1, -1]), H([7, -10]), H([2, 3]), H([2, -2])], 1),
    ("Slice_attrs", "Slice", {"starts": [0], "ends": [2], "axes": [1]},
     [D(X4)], 1),
    ("Split_sizes", "Split", {"axis": 1, "split": [1, 3]}, [D(X4)], 2),
    ("Split_even", "Split", {"axis": 3}, [D(X4)], 3),
    ("Split_remainder", "Split", {"axis": 2}, [D(X4)], 3),
    ("Pad_constant", "Pad", {},
     [D(X4), H([0, 0, 1, -1, 0, 0, 2, 1]), H(np.float32(0.5))], 1),
    ("Pad_reflect", "Pad", {"mode": "reflect"},
     [D(X4), H([0, 0, 2, 1, 0, 0, 1, 2])], 1),
    ("Pad_edge", "Pad", {"mode": "edge"},
     [D(X4), H([0, 1, 2, 1, 1, 0, 1, 3])], 1),
    ("Pad_attrs", "Pad", {"pads": [0, 0, 1, 1, 0, 0, 1, 1], "value": 1.5},
     [D(X4)], 1),
    ("ConstantOfShape", "ConstantOfShape",
     {"value": np.asarray([2.5], np.float32)}, [H([2, 3])], 1),
    ("Range", "Range", {},
     [H(np.int64(1)), H(np.int64(9)), H(np.int64(3))], 1),
    ("Where", "Where", {}, [D(B1), D(X4), D(_f(1, 4, 1, 9))], 1),
    ("Add", "Add", {}, [D(X4), D(_f(4, 1, 9))], 1),
    ("Add_host_scalar", "Add", {}, [D(X4), H(np.float32(0.25))], 1),
    ("Sub", "Sub", {}, [D(X4), D(_f(9))], 1),
    ("Mul", "Mul", {}, [D(X4), D(_f(2, 4, 1, 1))], 1),
    ("Div", "Div", {}, [D(X4), D(_f(1, 4, 7, 1, lo=0.5))], 1),
    ("Div_int_host_truncates", "Div", {}, [H(_i(12)), H(_i(12, lo=1))], 1),
    ("Div_int_host_negative", "Div", {},
     [H([-7, 7, -7, 5]), H([2, -2, -2, 3])], 1),
    ("Div_int_device", "Div", {},
     [D(_i(12, lo=0, hi=40)), D(_i(12, lo=1, hi=7))], 1),
    ("Pow", "Pow", {}, [D(_f(3, 5, lo=0.1)), D(_f(3, 5))], 1),
    ("Equal", "Equal", {}, [D(_i(4, 5)), D(_i(4, 5))], 1),
    ("Greater", "Greater", {}, [D(X4), D(_f(9))], 1),
    ("Less", "Less", {}, [D(X4), H(np.float32(0.1))], 1),
    ("And", "And", {}, [D(B1), D(B2)], 1),
    ("Or", "Or", {}, [D(B1), D(B2)], 1),
    ("Min", "Min", {}, [D(X4), D(_f(9)), D(_f(4, 1, 1))], 1),
    ("Max", "Max", {}, [D(X4), D(_f(9)), D(_f(4, 1, 1))], 1),
    ("Sum", "Sum", {}, [D(X4), D(_f(9)), D(_f(4, 1, 1))], 1),
    ("Mean", "Mean", {}, [D(X4), D(_f(9)), D(_f(4, 1, 1))], 1),
    ("Neg", "Neg", {}, [D(X4)], 1),
    ("Abs", "Abs", {}, [D(X4)], 1),
    ("Sqrt", "Sqrt", {}, [D(_f(3, 4, lo=0.0))], 1),
    ("Exp", "Exp", {}, [D(X4)], 1),
    ("Log", "Log", {}, [D(_f(3, 4, lo=0.1))], 1),
    ("Floor", "Floor", {}, [D(X4 * 3)], 1),
    ("Ceil", "Ceil", {}, [D(X4 * 3)], 1),
    ("Not", "Not", {}, [D(B1)], 1),
    ("Reciprocal", "Reciprocal", {}, [D(_f(3, 4, lo=0.5))], 1),
    ("Tanh", "Tanh", {}, [D(X4)], 1),
    ("Sigmoid", "Sigmoid", {}, [D(X4)], 1),
    ("Sigmoid_host", "Sigmoid", {}, [H(_f(5))], 1),
    ("Relu", "Relu", {}, [D(X4)], 1),
    ("LeakyRelu", "LeakyRelu", {"alpha": 0.2}, [D(X4)], 1),
    ("PRelu_channels", "PRelu", {}, [D(X4), D(_f(4))], 1),
    ("PRelu_chw", "PRelu", {}, [D(X4), D(_f(4, 1, 1))], 1),
    ("Elu", "Elu", {"alpha": 0.7}, [D(X4)], 1),
    ("HardSigmoid", "HardSigmoid", {"alpha": 0.3, "beta": 0.4}, [D(X4)], 1),
    ("HardSwish", "HardSwish", {}, [D(X4 * 4)], 1),
    ("Softplus", "Softplus", {}, [D(X4 * 4)], 1),
    ("Clip_attrs", "Clip", {"min": -0.5, "max": 0.5}, [D(X4)], 1),
    ("Clip_inputs", "Clip", {},
     [D(X4), H(np.float32(-0.3)), H(np.float32(0.4))], 1),
    ("Clip_min_only", "Clip", {}, [D(X4), H(np.float32(-0.1))], 1),
    ("Clip_max_only", "Clip", {}, [D(X4), None, H(np.float32(0.2))], 1),
    ("Softmax_opset13", "Softmax", {"axis": 1}, [D(X4)], 1),
    ("Softmax_opset11_flattens", "Softmax", {"axis": 1}, [D(X4)], 1),
    ("ReduceMean_attr", "ReduceMean", {"axes": [2, 3], "keepdims": 0},
     [D(X4)], 1),
    ("ReduceSum_input", "ReduceSum", {}, [D(X4), H([1])], 1),
    ("ReduceMax", "ReduceMax", {"axes": [-1]}, [D(X4)], 1),
    ("ReduceMin_all", "ReduceMin", {}, [D(X4)], 1),
    ("ReduceProd", "ReduceProd", {"axes": [1, 3], "keepdims": 0},
     [D(_f(2, 3, 4, 2, lo=0.5))], 1),
    ("ReduceProd_keepdims", "ReduceProd", {"axes": [2]},
     [D(_f(2, 3, 4, lo=0.5))], 1),
    ("MatMul", "MatMul", {}, [D(_f(2, 3, 5)), D(_f(5, 4))], 1),
    ("Gemm", "Gemm", {"alpha": 0.5, "beta": 2.0, "transA": 1, "transB": 1},
     [D(_f(5, 3)), D(_f(4, 5)), D(_f(4))], 1),
    ("Gemm_plain", "Gemm", {}, [D(_f(3, 5)), D(_f(5, 4))], 1),
    ("Conv_asymmetric_pads", "Conv",
     {"pads": [1, 0, 2, 1], "kernel_shape": [3, 3]},
     [D(XP), D(_f(6, 4, 3, 3)), D(_f(6))], 1),
    ("Conv_same_upper", "Conv",
     {"auto_pad": "SAME_UPPER", "strides": [2, 2], "kernel_shape": [3, 3]},
     [D(XP), D(_f(6, 4, 3, 3))], 1),
    ("Conv_same_lower", "Conv",
     {"auto_pad": "SAME_LOWER", "strides": [2, 2], "dilations": [2, 1],
      "kernel_shape": [4, 4]}, [D(XP), D(_f(6, 4, 4, 4))], 1),
    ("Conv_valid_groups", "Conv",
     {"auto_pad": "VALID", "group": 2, "kernel_shape": [3, 3]},
     [D(XP), D(_f(6, 2, 3, 3))], 1),
    ("BatchNormalization", "BatchNormalization", {"epsilon": 1e-3},
     [D(X4), D(_f(4)), D(_f(4)), D(_f(4)), D(_f(4, lo=0.5))], 1),
    ("MaxPool_ceil_pads", "MaxPool",
     {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 0, 0, 1],
      "ceil_mode": 1}, [D(XP)], 1),
    ("MaxPool_same_upper", "MaxPool",
     {"kernel_shape": [2, 3], "strides": [2, 2], "auto_pad": "SAME_UPPER"},
     [D(XP)], 1),
    ("MaxPool_dilated", "MaxPool",
     {"kernel_shape": [2, 2], "dilations": [2, 3]}, [D(XP)], 1),
    ("AveragePool_exclude_pad", "AveragePool",
     {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]},
     [D(XP)], 1),
    ("AveragePool_include_pad_ceil", "AveragePool",
     {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 0, 0],
      "count_include_pad": 1, "ceil_mode": 1}, [D(XP)], 1),
    ("AveragePool_dilated", "AveragePool",
     {"kernel_shape": [2, 2], "dilations": [2, 2], "pads": [1, 1, 1, 1]},
     [D(XP)], 1),
    ("GlobalAveragePool", "GlobalAveragePool", {}, [D(X4)], 1),
    ("GlobalMaxPool", "GlobalMaxPool", {}, [D(X4)], 1),
    ("Resize_default_half_pixel", "Resize", {},
     [D(X4), None, H(np.asarray([1, 1, 2, 1.5], np.float32))], 1),
    ("Resize_asymmetric_floor", "Resize",
     {"coordinate_transformation_mode": "asymmetric",
      "nearest_mode": "floor"},
     [D(X4), None, H(np.asarray([1, 1, 2, 2], np.float32))], 1),
    ("Resize_round_prefer_ceil_down", "Resize",
     {"nearest_mode": "round_prefer_ceil"},
     [D(XP), None, H(np.asarray([1, 1, 0.5, 0.7], np.float32))], 1),
    ("Resize_tf_half_pixel_ceil", "Resize",
     {"coordinate_transformation_mode": "tf_half_pixel_for_nn",
      "nearest_mode": "ceil"},
     [D(X4), None, H(np.asarray([1, 1, 1.5, 2], np.float32))], 1),
    ("Resize_linear_align_corners_sizes", "Resize",
     {"mode": "linear", "coordinate_transformation_mode": "align_corners"},
     [D(X4), None, H(np.zeros(0, np.float32)), H([2, 4, 12, 5])], 1),
    ("Resize_linear_pytorch_half_pixel", "Resize",
     {"mode": "linear",
      "coordinate_transformation_mode": "pytorch_half_pixel"},
     [D(X4), None, H(np.asarray([1, 1, 2.5, 0.5], np.float32))], 1),
    ("Resize_opset10_scales_at_input_1", "Resize", {},
     [D(X4), H(np.asarray([1, 1, 2, 2], np.float32))], 1),
    ("Resize_int_nearest", "Resize", {},
     [D(_i(1, 2, 3, 4)), None, H(np.asarray([1, 1, 2, 2], np.float32))], 1),
    ("Resize_int_linear", "Resize", {"mode": "linear"},
     [D(_i(1, 2, 3, 4)), None, H(np.asarray([1, 1, 2, 2], np.float32))], 1),
    ("Upsample", "Upsample", {},
     [D(X4), H(np.asarray([1, 1, 2, 3], np.float32))], 1),
]


def _run(lite, exe, op, attrs, inputs, n_out, side, opset):
    """One node of ``op`` through an interpreter's ``_OPS`` entry."""
    node = lite.OnnxNode(op, [f"i{k}" if v is not None else ""
                              for k, v in enumerate(inputs)],
                         [f"o{k}" for k in range(n_out)], name="n",
                         attrs=dict(attrs))
    vals = []
    for v in inputs:
        if v is None:
            vals.append(None)
        elif v[0] == "h":
            vals.append(v[1].copy())
        elif side == "jax":
            vals.append(jnp.asarray(v[1]))
        else:
            vals.append(torch.from_numpy(np.array(v[1])))
    fn = exe._OPS[op]
    if op == "Softmax":
        out = fn(node, vals, {"opset": opset})
    else:
        out = fn(node, vals)
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.numpy() if isinstance(o, torch.Tensor) else o)
            for o in outs]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    name, op, attrs, inputs, n_out = case
    opset = 11 if "opset11" in name else 13
    want = _run(JL, JX, op, attrs, inputs, n_out, "jax", opset)
    got = _run(TL, TX, op, attrs, inputs, n_out, "torch", opset)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert g.dtype.kind == w.dtype.kind, (g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)


def test_softmax_before_opset13_flattens():
    """Below opset 13 the softmax runs over every axis from ``axis`` on."""
    node = TL.OnnxNode("Softmax", ["x"], ["y"], attrs={"axis": 1})
    x = torch.from_numpy(X4)
    old = TX._OPS["Softmax"](node, [x], {"opset": 11})
    new = TX._OPS["Softmax"](node, [x], {"opset": 13})
    np.testing.assert_allclose(old.sum(dim=(1, 2, 3)).numpy(), 1.0,
                               rtol=1e-5)
    assert not torch.allclose(old, new)


def test_data_dependent_ops_are_rejected_alike():
    graph = dict(nodes=[JL.OnnxNode("NonZero", ["x"], ["y"]),
                        JL.OnnxNode("NonMaxSuppression", ["b", "s"], ["z"])],
                 initializers={}, input_names=["x", "b", "s"],
                 input_shapes={}, output_names=["y", "z"])
    with pytest.raises(NotImplementedError) as want:
        JX.OnnxModule(JL.OnnxGraph(**graph))
    with pytest.raises(NotImplementedError) as got:
        TX.OnnxModule(TL.OnnxGraph(**graph))
    assert str(got.value) == str(want.value)


def test_onnx_lite_round_trip(tmp_path):
    """The port's writer gives JAX's bytes, and both readers read the same
    graph back."""
    w = _f(4, 3, 3, 3)
    nodes = [TL.OnnxNode("Conv", ["x", "w"], ["c"], name="c0",
                         attrs={"strides": [2, 2], "pads": [1, 1, 1, 1],
                                "kernel_shape": [3, 3], "auto_pad": "NOTSET",
                                "alpha": 0.5}),
             TL.OnnxNode("Gather", ["c", "i"], ["y"], attrs={"axis": -1})]
    inits = {"w": w, "i": np.asarray([-1, 2], np.int64),
             "h": np.asarray([1.5, -2.0], np.float16)}
    kw = dict(initializers=inits, inputs={"x": (None, 3, 8, 8)},
              outputs=["y"], opset=13)
    tp, jp = str(tmp_path / "t.onnx"), str(tmp_path / "j.onnx")
    TL.write_onnx(tp, nodes=nodes, **kw)
    JL.write_onnx(jp, nodes=[JL.OnnxNode(**n.__dict__) for n in nodes], **kw)
    assert filecmp.cmp(tp, jp, shallow=False)
    got, want = TL.parse_onnx(tp), JL.parse_onnx(tp)
    assert got.opset == want.opset == 13
    assert got.input_names == want.input_names == ["x"]
    assert got.input_shapes == want.input_shapes
    assert got.output_names == want.output_names == ["y"]
    assert [n.__dict__ for n in got.nodes] == [n.__dict__ for n in want.nodes]
    assert got.nodes[0].attrs["alpha"] == pytest.approx(0.5)
    for k, v in inits.items():
        np.testing.assert_array_equal(got.initializers[k], v)
        assert got.initializers[k].dtype == v.dtype
    assert set(TL.onnx_initializers(tp)) == set(inits)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """SCRFD-tiny at det 64 and the bundled ArcFace, written by both
    packages' exporters from the bundled weights."""
    d = tmp_path_factory.mktemp("onnx")
    paths = {}
    for side, mod in (("jax", JE), ("torch", TE)):
        for model, extra in (("scrfd_tiny", ["--det-size", "64"]),
                             ("arcface_synth", [])):
            p = str(d / f"{side}_{model}.onnx")
            assert mod.main(["--model", model, "--out", p] + extra) == 0
            paths[side, model] = p
    return paths


@pytest.mark.parametrize("model", ["scrfd_tiny", "arcface_synth"])
def test_export_writes_jax_bytes(exported, model):
    assert filecmp.cmp(exported["torch", model], exported["jax", model],
                       shallow=False)


def test_export_random_init_loads_back(tmp_path):
    """Without weights the exporter writes the port's seeded random init;
    the graph holds every tensor of the module."""
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models.onnx_zoo import OnnxArcFaceEncoder

    p = str(tmp_path / "tiny.onnx")
    assert TE.main(["--model", "arcface_tiny", "--weights", "random",
                    "--out", p]) == 0
    enc = OnnxArcFaceEncoder(p, device="cpu")
    assert enc.embed_dim == AF.TINY.embed_dim
    chips = torch.from_numpy(RNG.uniform(0, 255, (2, 112, 112, 3))
                             .astype(np.float32))
    emb = enc(chips)
    assert emb.shape == (2, AF.TINY.embed_dim)
    assert torch.isfinite(emb).all()


def test_scrfd_detector_matches_jax(exported):
    """The same detections, slot for slot, as the JAX adapter on the graph
    the JAX exporter wrote."""
    from person_capture_tpu.models.onnx_zoo import OnnxScrfdDetector as JD
    from person_capture_tpu_torch.models.onnx_zoo import \
        OnnxScrfdDetector as TD

    path = exported["jax", "scrfd_tiny"]
    jd = JD(path, det_size=64, max_faces=4)
    td = TD(path, det_size=64, max_faces=4, device="cpu")
    frames = RNG.uniform(0, 255, (3, 64, 64, 3)).astype(np.float32)
    scales = np.asarray([1.0, 0.5, 2.0], np.float32)
    want = jd(jnp.asarray(frames), jnp.asarray(scales), 0.02)
    got = td(torch.from_numpy(frames), torch.from_numpy(scales), 0.02)
    mask = np.asarray(want["mask"])
    assert mask.sum() >= 4, "too few detections to compare"
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5)
    for k in ("boxes", "kps"):
        np.testing.assert_allclose(got[k].numpy()[mask],
                                   np.asarray(want[k])[mask], atol=1e-3)


@pytest.mark.parametrize("flip_tta", [False, True])
def test_arcface_encoder_matches_jax(exported, flip_tta):
    from person_capture_tpu.models.onnx_zoo import OnnxArcFaceEncoder as JA
    from person_capture_tpu_torch.models.onnx_zoo import \
        OnnxArcFaceEncoder as TA

    path = exported["jax", "arcface_synth"]
    ja = JA(path, flip_tta=flip_tta)
    ta = TA(path, flip_tta=flip_tta, device="cpu")
    assert ta.embed_dim == ja.embed_dim == 256
    chips = RNG.uniform(0, 255, (4, 112, 112, 3)).astype(np.float32)
    want = np.asarray(ja(jnp.asarray(chips)))
    got = ta(torch.from_numpy(chips)).numpy()
    assert (1.0 - (got * want).sum(-1)).max() <= 1e-4


def test_backend_with_onnx_weights_matches_jax(exported):
    """The face backend built from the two ONNX files (letterbox → ONNX
    SCRFD → warp → ONNX ArcFace → pack) gives the JAX backend's slots."""
    from person_capture_tpu.pipeline.backends import \
        ScrfdArcFaceBackend as JB
    from person_capture_tpu_torch.pipeline.backends import \
        ScrfdArcFaceBackend as TB

    kw = dict(det_size=64, max_faces=4, score_thresh=0.02,
              scrfd_weights=exported["jax", "scrfd_tiny"],
              arcface_weights=exported["jax", "arcface_synth"])
    jb = JB(dtype=jnp.float32, **kw)
    tb = TB(dtype=torch.float32, device="cpu", **kw)
    assert tb.embed_dim == jb.embed_dim == 256
    frames = RNG.integers(0, 255, (2, 48, 64, 3), np.uint8)
    valid = np.ones(2, bool)
    want = jb.extract_batch(frames, valid)
    got = tb.extract_batch(frames, valid)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = want["mask"]
    assert m.any()
    np.testing.assert_allclose(got["boxes"][m], want["boxes"][m], atol=1e-3)
    assert (1.0 - (got["feats"][m] * want["feats"][m]).sum(-1)).max() <= 1e-4
