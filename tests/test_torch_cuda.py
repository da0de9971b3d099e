"""Tests of the port's hand-written CUDA kernels, which have no CPU mode.

Each skips where no CUDA device is present. On a machine with the card
(where JAX need not be installed) run them without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest

torch = pytest.importorskip("torch")

from person_capture_tpu_torch.kernels import hdr as H  # noqa: E402

ALGOS = ["clip", "reinhard", "mobius", "hable", "bt.2390"]
# largest share of pixels in which the fused entry may differ from its plain
# version (chip_smoke.DIFFER_LIMIT): a sound kernel differs in about 0.2 %
# of them, one that drops the dither, transposes the Bayer tile or
# truncates in 12 to 90 %
DIFFER_LIMIT = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("desat", [0.0, 0.25])
@pytest.mark.parametrize("algo", ALGOS)
def test_tonemap_kernel_matches_plain_version(cuda, algo, desat):
    """atol 2e-3: accurate powf on both sides, summed in another order."""
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.rand(3, 270, 481, device=cuda, generator=g)
    before = H.TONEMAP_LAUNCHES.count
    got = H.tonemap_planes(x, 1000.0, 100.0, algo, desat, 0.4)
    want = H.tonemap_planes_reference(x, 1000.0, 100.0, algo, desat, 0.4)
    torch.cuda.synchronize()
    assert H.TONEMAP_LAUNCHES.count == before + 1
    assert float((got - want).abs().max()) <= 2e-3


@pytest.mark.cuda
def test_tonemap_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.rand(3, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        H.tonemap_planes(x.double())
    with pytest.raises(ValueError, match=r"\[3, H, W\]"):
        H.tonemap_planes(x[:2])
    with pytest.raises(ValueError, match="contiguous"):
        H.tonemap_planes(x.transpose(1, 2))


def _p010_cuda(h, w, seed):
    """Seeded random P010 planes (10-bit codes in the high bits, the full
    code range) as the int16 CUDA tensors plane_tensor makes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1024, (h, w)).astype(np.uint16) << 6
    uv = rng.integers(0, 1024, (h // 2, w // 2, 2)).astype(np.uint16) << 6
    return H.plane_tensor(y, "cuda"), H.plane_tensor(uv, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("desat", [0.0, 0.25])
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_kernel_matches_plain_version(cuda, algo, desat, dither,
                                            full_range):
    """≤ 1 LSB (one rounding step), in at most DIFFER_LIMIT of the pixels,
    at an even size whose width is not a multiple of 4, so the per-pixel
    path and its masked tail run; one launch on the counter per call."""
    y, uv = _p010_cuda(270, 482, seed=1)
    args = (full_range, 1000.0, 100.0, algo, desat, 0.4, dither)
    before = H.HDR_TO_SDR_LAUNCHES.count
    got = H.hdr_to_sdr_bgr(y, uv, full_range, "pq", *args[1:])
    want = H.hdr_to_sdr_bgr_reference(y, uv, *args)
    torch.cuda.synchronize()
    assert H.HDR_TO_SDR_LAUNCHES.count == before + 1
    assert got.shape == (270, 482, 3) and got.dtype == torch.uint8
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff.amax(dim=-1) > 0).float().mean()) <= DIFFER_LIMIT


@pytest.mark.cuda
def test_fused_kernel_vector_path_matches_plain_version(cuda):
    """Width a multiple of 4: 8-byte Y loads and 32-bit BGR stores."""
    y, uv = _p010_cuda(64, 256, seed=2)
    got = H.hdr_to_sdr_bgr(y, uv, algo="auto", desat=0.25, param=0.4)
    want = H.hdr_to_sdr_bgr_reference(y, uv, algo="auto", desat=0.25,
                                      param=0.4)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff.amax(dim=-1) > 0).float().mean()) <= DIFFER_LIMIT


@pytest.mark.cuda
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    y, uv = _p010_cuda(8, 16, seed=3)
    with pytest.raises(ValueError, match="even"):
        H.hdr_to_sdr_bgr(y[:7], uv[:3])
    with pytest.raises(ValueError, match="even"):
        H.hdr_to_sdr_bgr(y[:, :15].contiguous(), uv[:, :7].contiguous())
    with pytest.raises(ValueError, match="int16"):
        H.hdr_to_sdr_bgr(y.int(), uv)
    with pytest.raises(ValueError, match="contiguous"):
        H.hdr_to_sdr_bgr(y[:, ::2], uv)
    with pytest.raises(ValueError, match=r"\[H/2, W/2, 2\]"):
        H.hdr_to_sdr_bgr(y, uv[:2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        H.hdr_to_sdr_bgr_cuda(y, uv.cpu())


# --- the CLI defaults on the card -------------------------------------------

def _default_fixture(d):
    """320×240 PQ-coded fixture with a person under a 24-px face (the size
    the bundled person weights find at det 640), two face segments, and its
    P010 planes at 640×480."""
    import cv2
    import numpy as np

    from person_capture_tpu_torch.video.synthetic import (
        FacePlacement, draw_face, generate_video, p010_from_pq_bgr,
        write_pq_video)

    sv = generate_video(str(d / "sdr.mp4"), width=320, height=240, fps=30,
                        total_frames=40, segments=[(5, 18, 0), (24, 34, 0)],
                        moving=True, seed=1, draw_body=True, face_px=24)
    write_pq_video(str(d / "sdr.mp4"), str(d / "vid.mp4"))
    ref = np.full((200, 200, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (40, 40, 160, 160)))
    cv2.imwrite(str(d / "ref.png"), ref)
    cap = cv2.VideoCapture(str(d / "vid.mp4"))
    planes = {}
    for i in range(40):
        ok, frame = cap.read()
        assert ok
        planes[i] = p010_from_pq_bgr(frame, 640, 480)
    cap.release()
    return sv.identity_spans(0), planes


def _default_run(d, planes, device, monkeypatch):
    """The port's CLI at its defaults with curation off; returns the hit
    frames and, per composed crop, whether a person box shaped it."""
    from person_capture_tpu_torch import main as M
    from person_capture_tpu_torch.core import compose_profiles as CP
    from person_capture_tpu_torch.hdr.exporter import ArrayP010Source

    composed = []
    compose = CP.compose_dataset_crop

    def spy(*a, **kw):
        composed.append((kw["frame_idx"], kw["subject_box"] is not None))
        return compose(*a, **kw)

    monkeypatch.setattr(CP, "compose_dataset_crop", spy)
    argv = ["--video", str(d / "vid.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(d / device), "--batch", "8", "--det-size", "320",
            "--prescan", "--device", device,
            "--set", "curate_enable=false", "--set", "prescan_cache_mode=off"]
    if device == "cpu":
        argv += ["--compute-dtype", "float32"]
    ap = M.build_parser()
    args = ap.parse_args(argv)
    cfg = M.build_config(args, ap)
    runtime = M.build_runtime(cfg, args, ap)
    if device == "cpu":          # the CPU yardstick runs YOLO in fp32 too
        runtime["person"].model.float()
    eng = M.make_engine(cfg, runtime, status=lambda *a, **k: None)
    eng.hdr_source_factory = lambda *_: ArrayP010Source(planes, 640, 480)
    res = eng.run()
    assert res.ok, res.error
    return sorted(h.frame for h in res.mainpass.hits), sorted(composed)


@pytest.mark.cuda
def test_default_configuration_run_on_the_card(cuda, tmp_path, monkeypatch):
    """The CLI defaults (YOLOv8n person detection in the combined program,
    madvr_like stills) in bf16 on the card, held by decisions to the same
    run in fp32 on the CPU: the same hits, and the same crops composed
    around a person box."""
    monkeypatch.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
    truth, planes = _default_fixture(tmp_path)
    hits, composed = _default_run(tmp_path, planes, "cuda", monkeypatch)
    cpu_hits, cpu_composed = _default_run(tmp_path, planes, "cpu",
                                          monkeypatch)
    assert hits and all(any(s <= f <= e for s, e in truth) for f in hits)
    assert hits == cpu_hits
    assert composed == cpu_composed
    assert any(person for _, person in composed)


@pytest.mark.cuda
def test_combined_program_matches_separate_programs(cuda):
    """One upload, one chain of ops, one download: the same face slots as
    the face program on the same batch, and the same person slots as the
    person program on the BGR that the same wire converts to."""
    import numpy as np

    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models import yolov8 as YV
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.pipeline.backends import (
        ScrfdArcFaceBackend, YoloPersonBackend)
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_person)

    face = ScrfdArcFaceBackend(
        SD.SCRFD_2_5G, AF.SYNTH_R18, det_size=640, max_faces=8,
        scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
        arcface_weights=resolve_weights("auto", "arcface_synth"))
    person = YoloPersonBackend(weights=resolve_weights("auto", "yolov8n"))
    rng = np.random.default_rng(0)
    frames = rng.integers(30, 70, (16, 480, 640, 3)).astype(np.uint8)
    for i in range(0, 16, 2):
        draw_person(frames[i], FacePlacement(i, 0, (200 + 10 * i, 150,
                                                    240 + 10 * i, 190)))
    valid = np.ones(16, bool)
    valid[-3:] = False
    face_a = face.submit_batch(frames, valid)()
    person_a = {k: v.cpu().numpy() for k, v in person.detect_device(
        face._convert(face._send(frames))).items()}
    person_a["mask"] &= valid[:, None]
    face_b, person_b = face.submit_wire_with_person(person, frames, valid)()
    np.testing.assert_array_equal(face_b["mask"], face_a["mask"])
    np.testing.assert_array_equal(person_b["mask"], person_a["mask"])
    m = person_a["mask"]
    np.testing.assert_allclose(person_b["boxes"][m], person_a["boxes"][m],
                               atol=0.5)
    assert person_a["mask"][:13:2].any(axis=1).all()
    assert face_a["mask"].any()


# --- ReID and curation on the card ------------------------------------------

def _cli_run(d, planes, device, flags=(), sets=()):
    """The port's CLI on :func:`_default_fixture` (``flags``/``sets`` added
    to the defaults); on the CPU the person detector and the ReID tower run
    in fp32 like the rest. Returns the hit frames and the output dir."""
    from person_capture_tpu_torch import main as M
    from person_capture_tpu_torch.hdr.exporter import ArrayP010Source

    out = d / f"{device}{'_'.join(flags)}"
    argv = ["--video", str(d / "vid.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(out), "--batch", "8", "--det-size", "320",
            "--prescan", "--device", device, *flags,
            "--set", "prescan_cache_mode=off"]
    for s in sets:
        argv += ["--set", s]
    if device == "cpu":
        argv += ["--compute-dtype", "float32"]
    ap = M.build_parser()
    args = ap.parse_args(argv)
    cfg = M.build_config(args, ap)
    runtime = M.build_runtime(cfg, args, ap)
    if device == "cpu":
        for key in ("person", "reid"):
            if runtime[key] is not None:
                runtime[key].model.float()
    eng = M.make_engine(cfg, runtime, status=lambda *a, **k: None)
    eng.hdr_source_factory = lambda *_: ArrayP010Source(planes, 640, 480)
    res = eng.run()
    assert res.ok, res.error
    return sorted(h.frame for h in res.mainpass.hits), out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["clip_reid_s", "ViT-L-14"])
def test_reid_tower_bf16_matches_fp32(cuda, name):
    """The ReID tower's bf16 default against fp32 on the card, on 16
    person-sized crops of mixed aspect: cosine ≥ 0.99 per crop (bundled
    weights for clip_reid_s, a seeded random init for ViT-L-14)."""
    import numpy as np

    from person_capture_tpu_torch.main import resolve_reid
    from person_capture_tpu_torch.models import clip_vit as CV
    from person_capture_tpu_torch.pipeline.backends import ClipReidBackend
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_person)

    cfg, w = (resolve_reid(name, "auto") if name == "clip_reid_s"
              else (CV.VIT_L_14, None))
    rng = np.random.default_rng(0)
    crops = []
    for i in range(16):
        h, wd = int(rng.integers(120, 400)), int(rng.integers(60, 200))
        c = rng.integers(30, 90, (h, wd, 3)).astype(np.uint8)
        s = wd // 3
        draw_person(c, FacePlacement(i, i % 3, (wd // 2 - s // 2, 10,
                                                wd // 2 + s // 2, 10 + s)))
        crops.append(c)
    half = ClipReidBackend(cfg=cfg, weights=w)
    full = ClipReidBackend(cfg=cfg, weights=w, dtype=torch.float32)
    assert half.dtype == torch.bfloat16 and half.device.type == "cuda"
    cos = (half.extract(crops) * full.extract(crops)).sum(-1)
    print(name, "bf16 vs fp32 cosine", cos.min(), cos.mean())
    assert cos.min() >= 0.99


@pytest.mark.cuda
def test_reid_either_run_on_the_card(cuda, tmp_path, monkeypatch):
    """``--match-mode either`` in bf16 on the card, held by decisions to the
    same run in fp32 on the CPU: the same hit frames."""
    monkeypatch.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
    truth, planes = _default_fixture(tmp_path)
    flags = ("--match-mode", "either")
    hits, _ = _cli_run(tmp_path, planes, "cuda", flags)
    cpu_hits, _ = _cli_run(tmp_path, planes, "cpu", flags)
    assert hits and all(any(s <= f <= e for s, e in truth) for f in hits)
    assert hits == cpu_hits


@pytest.mark.cuda
def test_curation_run_on_the_card(cuda, tmp_path, monkeypatch):
    """The CLI defaults with curation on, on the card, against the same run
    in fp32 on the CPU: the same curated set, or one image different (the
    bf16 face distances and quality scores sit near the gates and ties)."""
    import os

    monkeypatch.setenv("PERSON_CAPTURE_FORCE_HDR", "1")
    truth, planes = _default_fixture(tmp_path)
    _, out = _cli_run(tmp_path, planes, "cuda")
    _, cpu_out = _cli_run(tmp_path, planes, "cpu")

    def picked(o):
        return {f for f in os.listdir(o / "dataset_out")
                if f.endswith((".png", ".jpg"))}

    got, want = picked(out), picked(cpu_out)
    print("card only:", sorted(got - want), "CPU only:", sorted(want - got))
    assert got and len(got ^ want) <= 2 and abs(len(got) - len(want)) <= 1


# ---- the trainers, the running statistics and host alignment ----

TRAINERS = {
    "scrfd_synth": dict(cfg_name="scrfd_tiny", size=64, batch=4),
    "yolo_synth": dict(cfg_name="yolo_tiny", size=64, batch=4),
    "yolo_face_synth": dict(cfg_name="yolo_face_tiny", size=64, batch=4),
    "arcface_synth": dict(cfg_name="arcface_tiny", batch=4, num_ident=8),
    "clip_reid_synth": dict(cfg_name="clip_tiny", batch=4, num_ident=8),
}


@pytest.fixture
def no_tf32():
    """Card against CPU: fp32 convolutions and matmuls without TF32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_train_steps_on_the_card_match_the_cpu(cuda, no_tf32, name):
    """Three steps of each trainer family at tiny width from the same init
    and batches: losses rel ≤ 1e-4, parameters within 2·Σ lr_k (Adam moves
    an element whose gradient is rounding noise by up to lr a step)."""
    import importlib

    import numpy as np

    from person_capture_tpu_torch.models.bridge import flax_variables
    from person_capture_tpu_torch.tools.weights import flatten_tree
    from person_capture_tpu_torch.train.loop import warmup_cosine

    mod = importlib.import_module(f"person_capture_tpu_torch.train.{name}")
    out = {}
    for dev in ("cpu", "cuda"):
        run = mod.setup(steps=3, seed=2, device=dev, **TRAINERS[name])
        losses = [float(run.step(i)["loss"]) for i in range(3)]
        out[dev] = losses, flatten_tree(flax_variables(run.state.model))
    lr = run.state.sched.base_lrs[0]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    tol = 2 * sum(warmup_cosine(i, lr, 3) for i in range(3))
    for k, want in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k], want, rtol=1e-4,
                                   atol=tol if k.startswith("params/")
                                   else 1e-4, err_msg=k)


@pytest.mark.cuda
def test_flax_batchnorm_statistics_on_the_card(cuda):
    """The training step writes flax's running statistics on the card:
    momentum 0.99 and the biased batch variance (ArcFace's final
    BatchNorm1d at its batch of 48)."""
    from person_capture_tpu_torch.models.layers import BatchNorm1d

    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(48, 256, device=cuda, generator=g) * 2 + 1
    bn = BatchNorm1d(256, eps=1e-5, momentum=0.01).to(cuda).train()
    bn(x)
    torch.cuda.synchronize()
    var = x.var(0, unbiased=False)
    assert torch.allclose(bn.running_var, 0.99 + 0.01 * var, rtol=1e-6)
    assert torch.allclose(bn.running_mean, 0.01 * x.mean(0), rtol=1e-5,
                          atol=1e-7)


@pytest.mark.cuda
def test_host_align_on_the_card(cuda, no_tf32):
    """Detect on the card, cv2 warp on the host, embed on the card: the
    same slots as the fused chain from the same BGR frames, cosine ≥ 0.99
    (reflect-border cv2 warp against the device warp), and ≥ 0.9999 to the
    same mode on the CPU."""
    import numpy as np

    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.pipeline.backends import \
        ScrfdArcFaceBackend
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face)

    frames = np.full((2, 320, 320, 3), 60, np.uint8)
    for k in range(2):
        draw_face(frames[k], FacePlacement(k, 0, (40 + 9 * k, 40, 104, 120)))
        draw_face(frames[k], FacePlacement(k, 1, (190, 150, 250, 226)))
    kw = dict(det_size=320, dtype=torch.float32,
              scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
              arcface_weights=resolve_weights("auto", "arcface_synth"))
    valid = np.ones(2, bool)
    host = ScrfdArcFaceBackend(SD.SCRFD_2_5G, AF.SYNTH_R18, device=cuda,
                               host_align=True, **kw)
    got = host.submit_batch(frames, valid)()
    fused = ScrfdArcFaceBackend(SD.SCRFD_2_5G, AF.SYNTH_R18, device=cuda,
                                transfer_format="bgr", **kw
                                ).extract_batch(frames, valid)
    cpu = ScrfdArcFaceBackend(SD.SCRFD_2_5G, AF.SYNTH_R18, device="cpu",
                              host_align=True, **kw
                              ).extract_batch(frames, valid)
    m = got["mask"]
    assert m.sum() == 4
    np.testing.assert_array_equal(fused["mask"], m)
    np.testing.assert_array_equal(cpu["mask"], m)

    def cos(a, b):
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                  * np.linalg.norm(b, axis=-1))

    assert (cos(got["feats"][m], fused["feats"][m]) >= 0.99).all()
    assert (cos(got["feats"][m], cpu["feats"][m]) >= 0.9999).all()


@pytest.mark.cuda
def test_sharded_step_on_one_card_matches_unsharded(cuda):
    """The bf16 step on four mesh entries of the one card (data:2,
    model:2: two replicas on their own CUDA streams, each with its wide
    layers split in two) against the unsharded backend from the same BGR
    frames, a face in every even frame and none in the odd ones: the same
    slots and decisions, ``best_fd`` within 2e-2 and boxes within
    0.5 px."""
    import numpy as np

    from person_capture_tpu_torch.core.bank import fd_min_batch
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_prescan_step, make_mesh)
    from person_capture_tpu_torch.pipeline.backends import \
        ScrfdArcFaceBackend
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face)

    frames = np.full((8, 240, 320, 3), 60, np.uint8)
    for k in range(0, 8, 2):
        # one 90x110 face, the window test's, moved along the frame
        draw_face(frames[k], FacePlacement(k, 0, (60 + 16 * k, 60,
                                                  150 + 16 * k, 170)))
    w = dict(scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
             arcface_weights=resolve_weights("auto", "arcface_synth"))
    single = ScrfdArcFaceBackend(arcface_cfg=AF.SYNTH_R18, det_size=640,
                                 device=cuda, transfer_format="bgr", **w)
    want = single.extract_batch(frames, np.ones(8, bool))
    m = want["mask"]
    assert m[::2].any(1).all() and not m[1::2].any()
    bank = want["feats"][0][m[0]][:1]
    run = build_sharded_prescan_step(
        make_mesh("data:2,model:2", devices=[cuda] * 4),
        arcface_cfg=AF.SYNTH_R18, det_size=640,
        scrfd_vars=w["scrfd_weights"], arcface_vars=w["arcface_weights"])
    got = {k: v.cpu().numpy() for k, v in
           run(frames, bank, np.ones(1, bool), 0.5).items()}
    _, best = fd_min_batch(torch.from_numpy(want["feats"]),
                           torch.from_numpy(m), torch.from_numpy(bank),
                           torch.ones(1, dtype=torch.bool))
    best = best.numpy()
    np.testing.assert_array_equal(got["mask"], m)
    np.testing.assert_array_equal(got["best_fd"] < 0.32, best < 0.32)
    assert np.abs(got["best_fd"] - best).max() <= 2e-2
    assert np.abs(got["boxes"][m] - want["boxes"][m]).max() <= 0.5


@pytest.mark.cuda
def test_gui_default_backend_on_the_card(cuda, monkeypatch):
    """The window's default backend under the fake Qt builds on the card
    (the device field's default) and finds the drawn face."""
    import sys

    import numpy as np

    import fake_qt
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face)

    fake_qt.install(monkeypatch)
    monkeypatch.setattr(fake_qt.QSettings, "_stores", {})
    monkeypatch.delitem(sys.modules, "person_capture_tpu_torch.gui_app",
                        raising=False)
    from person_capture_tpu_torch import gui_app

    win = gui_app.MainWindow()
    assert win._collect_cfg().device == "cuda"
    face = win._default_backend()
    assert face.inner.device.type == "cuda"
    assert face.inner.dtype == torch.bfloat16
    frame = np.full((1, 240, 320, 3), 60, np.uint8)
    draw_face(frame[0], FacePlacement(0, 0, (100, 60, 190, 170)))
    out = face.extract_batch(frame, np.ones(1, bool))
    assert out["mask"].sum() == 1
    person = win._aux_factories(win.cfg)["person"]()
    assert person.device.type == "cuda"
    sys.modules.pop("person_capture_tpu_torch.gui_app", None)


_SHARE_CHILD = r"""
import json, sys
from person_capture_tpu_torch.parallel import mesh as M, multihost as MH
MH.initialize(coordinator=f"127.0.0.1:{sys.argv[2]}", num_processes=2,
              process_id=int(sys.argv[1]))
try:
    mesh = M.make_mesh("data:2")
    print("MESH " + json.dumps([[str(d) for d in mesh.devices],
                                mesh.local_replicas()]))
except ValueError as e:
    print("REFUSED " + str(e))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("share", [False, True], ids=["refused", "shared"])
def test_torchrun_processes_and_the_share_setting(cuda, share):
    """Two processes with torchrun's LOCAL_RANK 0 and 1 of 2: each takes
    its own card where the host has two; on one card they would share it,
    which ``make_mesh`` refuses, naming PERSON_CAPTURE_SHARE_CARDS=1, unless
    that is set (then each process computes one replica on it)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=repo, LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2")
        env.pop("PERSON_CAPTURE_SHARE_CARDS", None)
        if share:
            env["PERSON_CAPTURE_SHARE_CARDS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _SHARE_CHILD, str(rank), str(port)],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            assert p.returncode == 0, se[-2000:]
            outs.append(so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    one_card = torch.cuda.device_count() < 2
    for rank, so in enumerate(outs):
        if one_card and not share:
            assert "REFUSED" in so and "PERSON_CAPTURE_SHARE_CARDS=1" in so
            continue
        devices, local = json.loads(so.split("MESH ", 1)[1])
        assert local == [rank]
        assert devices == (["cuda:0", "cuda:0"] if one_card
                           else ["cuda:0", "cuda:1"])


# ---- the spatially sharded full-frame detect and the sharded train step ----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_detect_on_one_card_matches_unsharded(cuda, no_tf32, dtype):
    """SCRFD-2.5G (bundled) at det 1408 with H split over ``model:4`` on
    four entries of the card, against the unsharded ``detect_faces`` on
    two canvases, each with one face inside a slab and one across a slab
    edge: the same slots, boxes within 0.5 px, scores within 1e-3 in fp32
    (TF32 off)."""
    import numpy as np

    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models.bridge import load_scrfd
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_fullframe_detect, make_mesh)
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face)

    size, slab = 1408, 352
    canvases = np.full((2, size, size, 3), 70, np.uint8)
    for i in range(2):
        y = slab * (2 * i + 1) + 60
        draw_face(canvases[i], FacePlacement(0, 0, (200, y, 320, y + 130)))
        edge = slab * (i + 1)
        draw_face(canvases[i], FacePlacement(0, 1, (900, edge - 70,
                                                    1030, edge + 70)))
    canvases = canvases.astype(np.float32)
    weights = resolve_weights("auto", "scrfd_2.5g")
    dt = getattr(torch, dtype)
    run = build_sharded_fullframe_detect(
        make_mesh("data:1,model:4", devices=[cuda] * 4), det_size=size,
        dtype=dt, scrfd_vars=weights)
    assert run.spatial
    got = {k: v.cpu().numpy() for k, v in
           run(canvases, np.ones(2, np.float32), 0.5).items()}
    model = load_scrfd(SD.SCRFD(SD.SCRFD_2_5G), weights).eval().to(
        device=cuda, dtype=dt)
    want = {k: v.cpu().numpy() for k, v in SD.detect_faces(
        model, torch.from_numpy(canvases).to(cuda), torch.ones(2), 0.5,
        8).items()}
    m = want["mask"]
    assert m.sum(1).tolist() == [2, 2]
    np.testing.assert_array_equal(got["mask"], m)
    assert np.abs(got["boxes"][m] - want["boxes"][m]).max() <= 0.5
    if dtype == "float32":
        assert np.abs(got["scores"][m] - want["scores"][m]).max() <= 1e-3


@pytest.mark.cuda
def test_sharded_train_step_on_one_card_matches_unsharded(cuda, no_tf32):
    """One step of SCRFD-2.5G at 128 px, batch 8, on ``data:2,model:2``
    over four entries of the card (TF32 off) against the unsharded step on
    the same global batch: the loss rel ≤ 1e-4, npos equal, every gradient
    and running statistic within 1e-4 of its leaf's largest entry."""
    import copy

    import numpy as np

    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.parallel.mesh import (
        build_sharded_train_step, make_mesh)
    from person_capture_tpu_torch.train.loop import to_device
    from person_capture_tpu_torch.train.scenes import sample_batch
    from person_capture_tpu_torch.train.scrfd_synth import (build_targets,
                                                            make_loss_fn)

    cfg, size = SD.SCRFD_2_5G, 128
    step, state, model = build_sharded_train_step(
        make_mesh("data:2,model:2", devices=[cuda] * 4), scrfd_cfg=cfg,
        size=size)
    twin = copy.deepcopy(model)
    d = sample_batch(np.random.default_rng(5), 8, size)
    targets = build_targets(d["boxes"], d["kps"], d["gt_mask"], size,
                            cfg.strides, cfg.num_anchors)
    state, metrics = step(state, d["images"], targets)
    loss, aux = make_loss_fn(twin)(to_device(d["images"], cuda),
                                   to_device(targets, cuda))
    loss.backward()
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-4)
    assert int(metrics["npos"]) == int(aux["npos"])
    for p, q in zip(model.parameters(), twin.parameters()):
        assert (p.grad - q.grad).abs().max() <= 1e-4 * q.grad.abs().max()
    for (n, a), b in zip(model.named_buffers(), twin.buffers()):
        if n.endswith(("running_mean", "running_var")):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max(), n


@pytest.mark.cuda
def test_dryrun_entry_on_the_card(cuda):
    """``dryrun.entry()``: the fused SCRFD-2.5G + ArcFace-r50 step at the
    JAX file's shapes on the card, outputs of the step's shapes."""
    from person_capture_tpu_torch.dryrun import entry

    fn, args = entry()
    best_fd, boxes, mask, quality = fn(*args)
    assert best_fd.shape == (2,) and boxes.shape == (2, 2, 4)
    assert mask.shape == quality.shape == (2, 2)
    assert best_fd.device.type == "cuda"
    assert torch.isfinite(best_fd).all()
