"""The whole slice: the JAX package's CLI pipeline and the torch port's, on
tiny synthetic HDR fixtures, must export the same frames and the same
full-resolution SDR stills — with the first slices' settings, and at the
CLI defaults (YOLOv8n person detection for body-aware crops, madvr_like
stills with colour match and despeckle) with only curation turned off.

Both run ``build_config`` → ``build_runtime`` → ``make_engine`` → ``run``
on the CPU in fp32 with the bundled weights, with ``PERSON_CAPTURE_FORCE_HDR``
and an in-memory P010 source at twice the analysis resolution.
Tolerances: identical ``index.csv`` frame lists (and crop boxes at the
defaults); every still within 1 LSB. At the defaults the JAX package's still
render runs op by op (``jax.disable_jit``): its jitted program rounds about
1 % of a madvr_like still's pixels the other way, by up to 2 LSB, against
its own op-by-op evaluation (XLA rewrites x/c as x·(1/c) and fuses the
pows, which moves the clean tone-map by one step in about 0.5 % of the
pixels, and the colour match's LUT, steeper than 1 in places, carries such
a step to 2).
"""

import csv
import os

import cv2
import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu import main as JM  # noqa: E402
from person_capture_tpu.hdr.exporter import \
    ArrayP010Source as JArraySource  # noqa: E402
from person_capture_tpu.video.synthetic import (FacePlacement,  # noqa: E402
                                                draw_face, generate_video)
from person_capture_tpu_torch import main as TM  # noqa: E402
from person_capture_tpu_torch.hdr.exporter import \
    ArrayP010Source as TArraySource  # noqa: E402
from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    generate_video as generate_sized_video, p010_from_pq_bgr, write_pq_video)

W, H, N, DET = 160, 120, 40, 160
SLICE_SETS = ["compose_detect_person_for_face=false", "curate_enable=false",
              "hdr_sdr_quality=fast", "hdr_sdr_contrast_recovery=0"]
DEFAULT_SETS = ["curate_enable=false"]


def _make_fixture(d, face_px: int = 0, w: int = W, h: int = H):
    """``face_px`` > 0: a person (body under the face) with a face that
    small, which the bundled person weights find at det 640."""
    sdr = str(d / "sdr.mp4")
    vid = str(d / "vid.mp4")
    kw = dict(width=w, height=h, fps=30, total_frames=N,
              segments=[(5, 18, 0), (24, 34, 0)], moving=True, seed=1)
    if face_px:
        sv = generate_sized_video(sdr, draw_body=True, face_px=face_px, **kw)
    else:
        sv = generate_video(sdr, **kw)
    write_pq_video(sdr, vid)
    ref = np.full((200, 200, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (40, 40, 160, 160)))
    cv2.imwrite(str(d / "ref.png"), ref)
    planes = {}
    cap = cv2.VideoCapture(vid)
    for i in range(N):
        ok, frame = cap.read()
        assert ok
        planes[i] = p010_from_pq_bgr(frame, 2 * w, 2 * h)
    cap.release()
    return d, sv, planes


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _make_fixture(tmp_path_factory.mktemp("slice"))


@pytest.fixture(scope="module")
def body_fixture(tmp_path_factory):
    return _make_fixture(tmp_path_factory.mktemp("defaults"), face_px=24,
                         w=2 * W, h=2 * H)


def _argv(d, out, sets=SLICE_SETS, det=DET):
    argv = ["--video", str(d / "vid.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(out), "--batch", "8", "--det-size", str(det),
            "--prescan", "--device", "cpu", "--compute-dtype", "float32",
            "--set", "prescan_cache_mode=off",
            "--set", f"face_fullframe_imgsz={2 * det}"]
    for s in sets:
        argv += ["--set", s]
    return argv


def _run(M, source_cls, d, planes, out, sets=SLICE_SETS, runtime_hook=None,
         det=DET, w=W, h=H):
    ap = M.build_parser()
    args = ap.parse_args(_argv(d, out, sets, det))
    cfg = M.build_config(args, ap)
    runtime = M.build_runtime(cfg, args, ap)
    if runtime_hook is not None:
        runtime_hook(runtime)
    eng = M.make_engine(cfg, runtime, status=lambda *a, **k: None)
    eng.hdr_source_factory = lambda video, *_: source_cls(planes, 2 * w,
                                                          2 * h)
    res = eng.run()
    assert res.ok, res.error
    with open(os.path.join(out, "index.csv")) as fh:
        return list(csv.DictReader(fh))


def test_slice_matches_jax_pipeline(fixture, tmp_path, monkeypatch):
    d, sv, planes = fixture
    monkeypatch.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
    want = _run(JM, JArraySource, d, planes, tmp_path / "jax")
    got = _run(TM, TArraySource, d, planes, tmp_path / "torch")

    frames = [int(r["frame"]) for r in got]
    assert frames == [int(r["frame"]) for r in want]
    truth = sv.identity_spans(0)
    assert all(any(s <= f <= e for s, e in truth) for f in frames)
    assert all(any(s <= f <= e for f in frames) for s, e in truth)
    for gr, wr in zip(got, want):
        assert gr["crop_path"].endswith(".png")
        a = cv2.imread(str(tmp_path / "torch" / "crops" / gr["crop_path"]))
        b = cv2.imread(str(tmp_path / "jax" / "crops" / wr["crop_path"]))
        assert a is not None and b is not None
        # full resolution: the still is cut from the 2× P010 source
        assert a.shape == b.shape
        assert a.shape[0] >= 2 * (int(gr["y2"]) - int(gr["y1"])) - 4
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _float32_default(monkeypatch, cls, dtype):
    """Both packages' person detectors default to bf16 whatever
    --compute-dtype says; this parity run holds them in fp32."""
    init = cls.__init__
    names = init.__code__.co_varnames[1:init.__code__.co_argcount]
    defaults = list(init.__defaults__)
    defaults[names.index("dtype") - (len(names) - len(defaults))] = dtype
    monkeypatch.setattr(init, "__defaults__", tuple(defaults))


def test_defaults_match_jax_pipeline(body_fixture, tmp_path, monkeypatch):
    """The CLI defaults with curation off: person boxes from YOLOv8n in the
    combined face+person program shape the crops, stills are madvr_like."""
    from person_capture_tpu.pipeline import backends as JB
    from person_capture_tpu_torch.pipeline import backends as TB

    from person_capture_tpu.hdr import stills as JS

    d, sv, planes = body_fixture
    monkeypatch.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
    jitted = JS._get_render_fn

    def op_by_op(params):
        fn = jitted(params)

        def run(*a):
            with jax.disable_jit():
                return fn(*a)

        return run

    monkeypatch.setattr(JS, "_get_render_fn", op_by_op)
    _float32_default(monkeypatch, JB.YoloPersonBackend, jnp.float32)
    _float32_default(monkeypatch, TB.YoloPersonBackend, torch.float32)
    found = []

    def count_persons(runtime):
        person = runtime["person"]
        assert person.dtype == torch.float32 and person.det_size == 640
        fused = person._fused

        def counted(frames, conf):
            out = fused(frames, conf)
            found.append(int(out["mask"].sum()))
            return out

        person._fused = counted

    size = dict(det=2 * DET, w=2 * W, h=2 * H)
    want = _run(JM, JArraySource, d, planes, tmp_path / "jax",
                DEFAULT_SETS, **size)
    got = _run(TM, TArraySource, d, planes, tmp_path / "torch",
               DEFAULT_SETS, runtime_hook=count_persons, **size)

    assert found and sum(found) > 0, "the person detector found no box"
    keys = ("frame", "x1", "y1", "x2", "y2")
    assert [[r[k] for k in keys] for r in got] == \
        [[r[k] for k in keys] for r in want]
    truth = sv.identity_spans(0)
    frames = [int(r["frame"]) for r in got]
    assert frames and all(any(s <= f <= e for s, e in truth) for f in frames)
    for gr, wr in zip(got, want):
        a = cv2.imread(str(tmp_path / "torch" / "crops" / gr["crop_path"]))
        b = cv2.imread(str(tmp_path / "jax" / "crops" / wr["crop_path"]))
        assert a is not None and b is not None and a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _checkpoint(tmp_path, token: str) -> str:
    """Write the checkpoint a placeholder names, from the bundled weights:
    torch state dicts in the official names (``torch.save``), ONNX graphs
    (the port's exporter) and a converted ``src/`` ArcFace dump."""
    from person_capture_tpu_torch.models import arcface as TA
    from person_capture_tpu_torch.models import clip_vit as TC
    from person_capture_tpu_torch.models import yolov8 as TY
    from person_capture_tpu_torch.models.loaders import torch_state_dict
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.tools import convert_weights, onnx_export

    def save(kind, name, cfg, path):
        torch.save({k: torch.from_numpy(v) for k, v in torch_state_dict(
            kind, resolve_weights("auto", name), cfg).items()}, path)
        return path

    if token == "YOLO_PT":
        return save("yolov8", "yolov8n", TY.YOLOV8N,
                    str(tmp_path / "yolov8n.pt"))
    if token == "REID_PT":
        return save("clip", "clip_reid_s", TC.REID_S,
                    str(tmp_path / "reid.pt"))
    if token == "ARC_SRC":
        out = str(tmp_path / "arc_src.npz")
        pt = save("arcface", "arcface_synth", TA.SYNTH_R18,
                  str(tmp_path / "arc.pt"))
        assert convert_weights.main(["--src", pt, "--kind", "arcface",
                                     "--out", out]) == 0
        return out
    model = {"SCRFD_ONNX": "scrfd_2.5g", "ARC_ONNX": "arcface_synth"}[token]
    out = str(tmp_path / f"{model}.onnx")
    assert onnx_export.main(["--model", model, "--out", out,
                             "--det-size", str(DET)]) == 0
    return out


def _parsed(tmp_path, sets, extra):
    argv = _argv(tmp_path, tmp_path / "out") + [
        _checkpoint(tmp_path, a) if a.isupper() else a for a in extra]
    for s in sets:
        argv += ["--set", s]
    ap = TM.build_parser()
    args = ap.parse_args(argv)
    return ap, args, TM.build_config(args, ap)


@pytest.mark.parametrize("sets,extra,setting", [
    ([], ["--multihost"], "--multihost"),
    ([], ["--coordinator", "localhost:1234"], "--coordinator"),
    ([], ["--mesh", "data:2"], "--mesh"),
])
def test_unported_branches_raise_value_error(tmp_path, sets, extra, setting):
    """Every branch of the runtime the port does not carry is refused up
    front with the setting that avoids it — never built smaller in
    silence."""
    ap, args, cfg = _parsed(tmp_path, sets, extra)
    with pytest.raises(ValueError, match="not ported") as err:
        TM.build_runtime(cfg, args, ap)
    assert setting in str(err.value)


@pytest.mark.parametrize("sets,extra", [
    (["curate_enable=true"], []),
    ([], ["--match-mode", "either"]),
    (["use_arcface=false", "clip_face_backbone=clip_tiny"], []),
    ([], ["--match-mode", "both"]),
    ([], ["--face-model", "yolov8n-face"]),
    (["compose_detect_person_for_face=true"], ["--yolo", "YOLO_PT"]),
    (["reid_backbone=clip_reid_s"],
     ["--match-mode", "either", "--reid-weights", "REID_PT"]),
    ([], ["--scrfd-weights", "SCRFD_ONNX", "--arcface-weights", "ARC_ONNX"]),
    ([], ["--arcface-model", "arcface_synth", "--arcface-weights",
          "ARC_SRC"]),
])
def test_ported_branches_build(tmp_path, sets, extra):
    """The branches the earlier slices refused now build the backends the
    JAX runtime builds for them; checkpoints in every format the JAX CLI
    loads hold the bundled weights they were written from."""
    from person_capture_tpu_torch.models import clip_vit as TC
    from person_capture_tpu_torch.models import yolov8 as TY
    from person_capture_tpu_torch.models.bridge import flax_variables
    from person_capture_tpu_torch.models.onnx_zoo import (OnnxArcFaceEncoder,
                                                          OnnxScrfdDetector)
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.pipeline import backends as TB
    from person_capture_tpu_torch.tools.weights import flatten_tree

    def holds(model, bundled):
        """The model holds the bundled weights (in its own dtype: the
        person detector and the ReID tower run bf16)."""
        dtype = next(model.parameters()).dtype
        got = flatten_tree(flax_variables(model))
        want = flatten_tree(resolve_weights("auto", bundled))
        assert set(got) == set(want)
        for k, v in want.items():
            v = torch.from_numpy(np.asarray(v, np.float32)).to(dtype).float()
            assert np.array_equal(got[k], v.numpy()), k

    ap, args, cfg = _parsed(tmp_path, sets, extra)
    rt = TM.build_runtime(cfg, args, ap)
    face = rt["inner_face"]
    assert isinstance(face, TB.ScrfdArcFaceBackend)
    assert face.device.type == "cpu" and face.dtype == torch.float32
    if args.match_mode != "face_only":
        assert isinstance(rt["reid"], TB.ClipReidBackend)
        assert rt["reid"].embed_dim == TC.REID_S.embed_dim   # bundled
        assert isinstance(rt["person"], TB.YoloPersonBackend)
        assert cfg.disable_reid is False
    else:
        assert rt["reid"] is None
    if not cfg.use_arcface:
        assert face.clip_model is not None and face.arcface_model is None
        assert face.embed_dim == TC.TINY.embed_dim
        # the full-frame rescue embeds in the primary's space
        assert rt["fullframe"].use_arcface is False
        assert rt["fullframe"].embed_dim == face.embed_dim
    if "yolov8n-face" in extra:
        assert rt["face_cfg"] is TY.YOLOV8N_FACE
        assert isinstance(face.scrfd_model, TY.YoloV8)
    if cfg.curate_enable:
        assert rt["person"] is None and rt["reid"] is None
    if "YOLO_PT" in extra:
        holds(rt["person"].model, "yolov8n")
    if "REID_PT" in extra:
        holds(rt["reid"].model, "clip_reid_s")
    if "SCRFD_ONNX" in extra:
        assert isinstance(face.scrfd_model, OnnxScrfdDetector)
        assert isinstance(face.arcface_model, OnnxArcFaceEncoder)
        assert face.embed_dim == 256 and face.det_size == DET
    if "ARC_SRC" in extra:
        holds(face.arcface_model, "arcface_synth")
