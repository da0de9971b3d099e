"""The port's reference-compatible facades, its ``host_align`` mode and its
numpy oracles, held to the JAX package (CPU, fp32 on both sides, the same
bundled weights), in the manner of tests/test_facades.py.

Each facade is given the same fp32 backends in both packages (the JAX
facades build theirs in bf16); a last group builds the port's facades
from their own defaults (bf16, ``device="cpu"``) and holds them to the
fp32 results by decisions. The JAX programs are compiled once per module.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    FacePlacement, draw_face, draw_person)

DET = 320


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores, and these tiny CPU steps gain
    nothing from more threads but contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames():
    """Two 320×320 frames: a 60-px face, and a person under a 32-px face."""
    rng = np.random.default_rng(5)
    out = []
    for k in range(2):
        img = np.full((DET, DET, 3), 60, np.uint8)
        img += rng.integers(0, 12, img.shape, dtype=np.uint8)
        draw_face(img, FacePlacement(k, 0, (40 + 8 * k, 40, 100 + 8 * k,
                                            112)))
        draw_person(img, FacePlacement(k, 1, (200, 60 + 4 * k, 232,
                                              96 + 4 * k)))
        out.append(img)
    return np.stack(out)


FRAMES = _frames()


def _weights(name):
    from person_capture_tpu_torch.models.zoo import resolve_weights

    return resolve_weights("auto", name)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def face_backends():
    """One fp32 face backend per package; the host-align tests switch
    ``host_align`` on, which both read per call."""
    from person_capture_tpu.models import arcface as JAF
    from person_capture_tpu.models import scrfd as JSD
    from person_capture_tpu.pipeline import backends as JB
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.pipeline import backends as TB

    kw = dict(det_size=DET, scrfd_weights=_weights("scrfd_2.5g"),
              arcface_weights=_weights("arcface_synth"))
    return (JB.ScrfdArcFaceBackend(JSD.SCRFD_2_5G, JAF.SYNTH_R18,
                                   dtype=jnp.float32, **kw),
            TB.ScrfdArcFaceBackend(SD.SCRFD_2_5G, AF.SYNTH_R18,
                                   dtype=torch.float32, device="cpu", **kw))


@pytest.fixture(scope="module")
def faces(face_backends):
    """``FaceEmbedder.extract`` of frame 0 in both packages (fp32)."""
    from person_capture_tpu.face_embedder import FaceEmbedder as JF
    from person_capture_tpu_torch.face_embedder import FaceEmbedder as TF

    jb, tb = face_backends
    return JF(backend=jb).extract(FRAMES[0]), TF(backend=tb).extract(
        FRAMES[0])


def test_face_embedder_extract_matches_jax(faces):
    want, got = faces
    assert len(want) >= 1 and len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
        assert g["bbox"].dtype == np.int32
        assert _cos(g["feat"], w["feat"]) >= 0.9999
        np.testing.assert_allclose(g["kps"], w["kps"], atol=1e-2)
        assert g["quality"] == pytest.approx(w["quality"], rel=1e-3)
    from person_capture_tpu_torch.face_embedder import FaceEmbedder as TF

    assert TF.best_face(got)["quality"] == max(f["quality"] for f in got)


@contextlib.contextmanager
def _host_align(*backends):
    for b in backends:
        b.host_align = True
    try:
        yield
    finally:
        for b in backends:
            b.host_align = False


@pytest.fixture(scope="module")
def host_aligned(face_backends):
    valid = np.array([True, False])
    with _host_align(*face_backends):
        return tuple(b.extract_batch(FRAMES, valid) for b in face_backends)


def test_host_align_matches_jax(host_aligned):
    """Detect on the device, cv2 warp on the host, embed: the same slots
    and embeddings at cosine ≥ 0.9999 as the JAX backend's host-align."""
    want, got = host_aligned
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"][0].any() and not want["mask"][1].any()
    m = want["mask"]
    np.testing.assert_allclose(got["boxes"][m], want["boxes"][m], atol=1e-3)
    assert (_cos(got["feats"][m], want["feats"][m]) >= 0.9999).all()
    np.testing.assert_allclose(got["quality"][m], want["quality"][m],
                               rtol=1e-3)
    assert not got["feats"][~m].any() and not got["quality"][~m].any()


def test_host_align_submit_returns_the_result(face_backends, host_aligned):
    _jb, tb = face_backends
    with _host_align(tb):
        fetch = tb.submit_batch(FRAMES, np.array([True, False]))
    out = fetch()
    assert fetch() is out
    np.testing.assert_array_equal(out["feats"], host_aligned[1]["feats"])


def test_host_align_and_fused_find_the_same_faces(face_backends,
                                                  host_aligned):
    """The fused chain's device warp against the host's reflect-border cv2
    warp, on the port alone, both from the BGR frames (the I420 wire
    moves the colours the synthetic embedder keys on): the same slots,
    cosine ≥ 0.99."""
    _jb, tb = face_backends
    tb.transfer_format = "bgr"
    try:
        fused = tb.extract_batch(FRAMES, np.array([True, False]))
    finally:
        tb.transfer_format = "i420"
    host = host_aligned[1]
    m = host["mask"]
    np.testing.assert_array_equal(fused["mask"], m)
    assert (_cos(fused["feats"][m], host["feats"][m]) >= 0.99).all()


@pytest.fixture(scope="module")
def person_backends():
    from person_capture_tpu.models import yolov8 as JY
    from person_capture_tpu.pipeline import backends as JB
    from person_capture_tpu_torch.models import yolov8 as TY
    from person_capture_tpu_torch.pipeline import backends as TB

    w = _weights("yolov8n")
    return (JB.YoloPersonBackend(JY.YOLOV8N, det_size=DET, weights=w,
                                 dtype=jnp.float32),
            TB.YoloPersonBackend(TY.YOLOV8N, det_size=DET, weights=w,
                                 dtype=torch.float32, device="cpu"))


def test_person_detector_matches_jax(person_backends):
    from person_capture_tpu.detectors import PersonDetector as JP
    from person_capture_tpu_torch.detectors import PersonDetector as TP

    jb, tb = person_backends
    want = JP(backend=jb).detect(FRAMES[1], conf=0.25)
    got = TP(backend=tb).detect(FRAMES[1], conf=0.25)
    assert len(want) >= 1 and len(got) == len(want)
    for w, g in zip(want, got):
        assert g["cls"] == 0
        np.testing.assert_allclose(g["xyxy"], w["xyxy"], atol=1e-3)
        assert g["conf"] == pytest.approx(w["conf"], abs=1e-5)
    assert TP(backend=tb).detect(None) == []


CROPS = [FRAMES[1][60:260, 180:260], FRAMES[0][30:130, 30:110],
         FRAMES[1][:96, :96]]


@pytest.fixture(scope="module")
def reid_feats():
    from person_capture_tpu.models import clip_vit as JCV
    from person_capture_tpu.pipeline import backends as JB
    from person_capture_tpu.reid_embedder import ReIDEmbedder as JR
    from person_capture_tpu_torch.models import clip_vit as TCV
    from person_capture_tpu_torch.pipeline import backends as TB
    from person_capture_tpu_torch.reid_embedder import ReIDEmbedder as TR

    w = _weights("clip_reid_s")
    jr = JR(backend=JB.ClipReidBackend(JCV.REID_S, batch=4, weights=w,
                                       dtype=jnp.float32))
    tr = TR(backend=TB.ClipReidBackend(TCV.REID_S, batch=4, weights=w,
                                       dtype=torch.float32, device="cpu"))
    return jr.extract(CROPS), tr.extract(CROPS)


def test_reid_embedder_matches_jax(reid_feats):
    want, got = reid_feats
    assert len(got) == len(want) == 3
    assert (_cos(np.stack(got), np.stack(want)) >= 0.9999).all()


def test_oracles_match_jax(tmp_path):
    from person_capture_tpu.pipeline import backends as JB
    from person_capture_tpu_torch.pipeline import backends as TB
    from person_capture_tpu_torch.video.synthetic import generate_video

    sv = generate_video(str(tmp_path / "v.mp4"), width=160, height=120,
                        total_frames=12, segments=[(2, 9, 0), (4, 7, 1)],
                        seed=2)
    frames = np.zeros((6, 120, 160, 3), np.uint8)
    valid = np.array([True, True, True, False, True, True])
    idxs = np.array([1, 3, 5, 6, 8, 9])
    for kw in ({}, {"noise": 0.05, "scale": 0.5}):
        j = JB.OracleBackend(sv, **kw).extract_batch(frames, valid, idxs)
        t = TB.OracleBackend(sv, **kw).extract_batch(frames, valid, idxs)
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["mask"].sum() > 0
    j = JB.OraclePersonBackend(sv).detect_batch(frames, valid, idxs)
    t = TB.OraclePersonBackend(sv).detect_batch(frames, valid, idxs)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# ---- the port's facades from their own defaults (bf16, device="cpu") ----

def test_face_embedder_defaults(faces):
    from person_capture_tpu_torch.face_embedder import FaceEmbedder
    from person_capture_tpu_torch.pipeline.recovery import \
        RecoveringFaceBackend

    fe = FaceEmbedder(ctx="cpu", det_size=DET, arcface_model="arcface_synth",
                      arcface_weights=_weights("arcface_synth"))
    assert isinstance(fe._backend, RecoveringFaceBackend)
    got, want = fe.extract(FRAMES[0]), faces[1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=2)
        assert _cos(g["feat"], w["feat"]) >= 0.99


def test_person_detector_and_reid_defaults(person_backends, reid_feats):
    from person_capture_tpu_torch.detectors import PersonDetector
    from person_capture_tpu_torch.reid_embedder import ReIDEmbedder

    pd = PersonDetector(device="cpu", det_size=DET)
    assert pd._backend.device.type == "cpu"
    want = PersonDetector(backend=person_backends[1]).detect(FRAMES[1], 0.25)
    got = pd.detect(FRAMES[1], 0.25)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["xyxy"], w["xyxy"], atol=2)
    re = ReIDEmbedder(model_name="ViT-L-14", device="cpu")
    assert re._backend.embed_dim == 128         # the bundled clip_reid_s
    got = re.extract(CROPS)
    assert (_cos(np.stack(got), np.stack(reid_feats[1])) >= 0.99).all()


def test_facades_default_to_the_card(monkeypatch):
    """Without a card the default device raises; nothing falls back to the
    CPU."""
    from person_capture_tpu_torch.detectors import PersonDetector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        PersonDetector(det_size=DET)
