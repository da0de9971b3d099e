"""The torch ``ScrfdArcFaceBackend`` against the JAX package's on synthetic
frames: the whole fused chain (I420 wire → BGR → letterbox → SCRFD → NMS →
chip warp → ArcFace → quality → packed ``[B, F, 17+D]``), fp32 on both
sides with the bundled weights.

The combined face+person step (one upload, one chain of ops with YOLOv8n,
one packed download) against the JAX package's combined program, its face
half against the port's separate face program on the same wire; and
``submit_faces_and_persons``, the main pass's one dispatch rule, on the
backends wired as the GUI wires them.

Tolerances: identical valid slots; boxes and landmarks atol 1e-2 px; feats
cosine ≥ 0.9999; quality rtol 1e-3 (a variance of the warped chip); person
boxes atol 1e-2 px, scores atol 1e-4.
"""

from types import SimpleNamespace

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.models import arcface as JAF  # noqa: E402
from person_capture_tpu.models import scrfd as JSD  # noqa: E402
from person_capture_tpu.models import yolov8 as JY  # noqa: E402
from person_capture_tpu.models.zoo import resolve_weights  # noqa: E402
from person_capture_tpu.pipeline import backends as JB  # noqa: E402
from person_capture_tpu.video.synthetic import (FacePlacement,  # noqa: E402
                                                draw_face)
from person_capture_tpu_torch.models import arcface as TAF  # noqa: E402
from person_capture_tpu_torch.models import scrfd as TSD  # noqa: E402
from person_capture_tpu_torch.models import yolov8 as TY  # noqa: E402
from person_capture_tpu_torch.pipeline import backends as TB  # noqa: E402
from person_capture_tpu_torch.pipeline import recovery as TR  # noqa: E402
from person_capture_tpu_torch.video.synthetic import draw_person  # noqa: E402

DET = 160
MAX_FACES = 4


def _pair(embed_slots=0):
    sw = resolve_weights("auto", "scrfd_2.5g")
    aw = resolve_weights("auto", "arcface_synth")
    kw = dict(det_size=DET, score_thresh=0.3, max_faces=MAX_FACES,
              scrfd_weights=sw, arcface_weights=aw, embed_slots=embed_slots)
    jb = JB.ScrfdArcFaceBackend(JSD.SCRFD_2_5G, JAF.SYNTH_R18,
                                dtype=jnp.float32, **kw)
    tb = TB.ScrfdArcFaceBackend(TSD.SCRFD_2_5G, TAF.SYNTH_R18,
                                dtype=torch.float32, device="cpu", **kw)
    return jb, tb


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _frames(n=4, h=120, w=160):
    out = np.full((n, h, w, 3), 55, np.uint8)
    draw_face(out[0], FacePlacement(0, 0, (20, 10, 80, 90)))
    draw_face(out[1], FacePlacement(1, 1, (90, 40, 150, 115)))
    draw_face(out[1], FacePlacement(1, 2, (5, 5, 45, 55)))
    out[2] = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
    draw_face(out[3], FacePlacement(3, 0, (50, 30, 100, 95)))
    return out


def _check(got, want, min_faces=3):
    mask = want["mask"]
    np.testing.assert_array_equal(got["mask"], mask)
    assert mask.sum() >= min_faces
    for key in ("boxes", "kps"):
        np.testing.assert_allclose(got[key][mask], want[key][mask], atol=1e-2)
    np.testing.assert_allclose(got["scores"][mask], want["scores"][mask],
                               atol=1e-4)
    np.testing.assert_allclose(got["quality"][mask], want["quality"][mask],
                               rtol=1e-3)
    cos = (got["feats"][mask] * want["feats"][mask]).sum(-1)
    assert cos.min() >= 0.9999, cos
    assert got["feats"].shape == want["feats"].shape


def test_extract_batch(pair):
    jb, tb = pair
    assert (tb.det_size, tb.score_thresh, tb.max_faces, tb.embed_dim,
            tb.embed_slots) == (jb.det_size, jb.score_thresh, jb.max_faces,
                                jb.embed_dim, jb.embed_slots)
    frames = _frames()
    valid = np.array([True, True, True, False])
    _check(tb.extract_batch(frames, valid), jb.extract_batch(frames, valid))


def test_submit_batch_fetch(pair):
    jb, tb = pair
    frames = _frames()[:2]
    valid = np.ones(2, bool)
    fetch = tb.submit_batch(frames, valid)
    assert callable(fetch)
    valid[:] = False          # the closure owns its copy of the mask
    _check(fetch(), jb.submit_batch(frames, np.ones(2, bool))())


def test_embed_slots_mask_rule():
    jb, tb = _pair(embed_slots=1)
    frames = _frames()
    valid = np.ones(4, bool)
    got = tb.extract_batch(frames, valid)
    want = jb.extract_batch(frames, valid)
    assert not got["mask"][:, 1:].any()
    np.testing.assert_array_equal(got["mask"], want["mask"])
    cos = (got["feats"][got["mask"]] * want["feats"][want["mask"]]).sum(-1)
    assert cos.min() >= 0.9999


def test_extract_single_image(pair):
    jb, tb = pair
    img = np.full((300, 240, 3), 60, np.uint8)
    draw_face(img, FacePlacement(0, 0, (40, 60, 200, 250)))
    want = JB.extract_single_image(jb, img)
    got = TB.extract_single_image(tb, img)
    _check(got, want, min_faces=1)


def test_pad_batch_and_lazy_backend():
    frames = [np.full((4, 4, 3), i, np.uint8) for i in range(3)]
    for a, b in zip(TB.pad_batch(frames, 5, [7, 8, 9]),
                    JB.pad_batch(frames, 5, [7, 8, 9])):
        np.testing.assert_array_equal(a, b)
    built = []

    def factory():
        built.append(1)
        return type("B", (), {"extract_batch": lambda self, f, v: "out",
                              "det_size": 640})()

    lazy = TB.LazyBackend(factory)
    lazy.score_thresh = 0.25
    assert not built
    assert lazy.extract_batch(None, None) == "out"
    assert lazy.score_thresh == 0.25 and lazy.det_size == 640
    assert built == [1]


@pytest.fixture(scope="module")
def person_pair():
    w = resolve_weights("auto", "yolov8n")
    kw = dict(det_size=DET, conf=0.3, max_det=4, weights=w)
    return (JB.YoloPersonBackend(cfg=JY.YOLOV8N, dtype=jnp.float32, **kw),
            TB.YoloPersonBackend(cfg=TY.YOLOV8N, dtype=torch.float32,
                                 device="cpu", **kw))


def _frames_with_persons():
    """:func:`_frames` with small drawn persons, which the bundled person
    weights find on a 160 canvas."""
    out = _frames()
    draw_person(out[0], FacePlacement(0, 3, (110, 20, 124, 36)))
    draw_person(out[3], FacePlacement(3, 4, (12, 10, 26, 26)))
    return out


def _check_person(got, want):
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = want["mask"]
    np.testing.assert_allclose(got["boxes"][m], want["boxes"][m], atol=1e-2)
    np.testing.assert_allclose(got["scores"][m], want["scores"][m],
                               atol=1e-4)


def test_combined_wire_program_matches_jax(pair, person_pair):
    jb, tb = pair
    jp, tp = person_pair
    frames = _frames_with_persons()
    valid = np.array([True, True, True, False])
    want_face, want_person = jb.submit_wire_with_person(jp, frames, valid)()
    got_face, got_person = tb.submit_wire_with_person(tp, frames, valid)()
    _check(got_face, want_face)
    _check_person(got_person, want_person)
    assert want_person["mask"][0].any() and want_person["mask"][3].sum() == 0
    # the face half is the separate face program on the same i420 wire
    separate = tb.submit_batch(frames, valid)()
    for k in separate:
        np.testing.assert_allclose(got_face[k], separate[k], atol=1e-5,
                                   err_msg=k)


def test_recovery_facade_exposes_the_combined_program(pair, person_pair):
    """RecoveringFaceBackend mirrors the inner backend's combined entry,
    and only where the inner backend has it, so the main pass takes the
    combined step."""
    jb, tb = pair
    _, tp = person_pair
    rec = TR.RecoveringFaceBackend(tb, TR.RecoveryPolicy(rot_adaptive=False))
    assert hasattr(rec, "submit_wire_with_person")
    assert not hasattr(TR.RecoveringFaceBackend(TB.OracleBackend(None)),
                       "submit_wire_with_person")
    assert hasattr(tp, "detect_device")
    frames = _frames_with_persons()
    valid = np.array([True, True, True, False])
    face, person = rec.submit_wire_with_person(tp, frames, valid)()
    want_face, want_person = tb.submit_wire_with_person(tp, frames, valid)()
    np.testing.assert_array_equal(person["mask"], want_person["mask"])
    np.testing.assert_array_equal(face["mask"], want_face["mask"])
    assert set(face) >= {"boxes", "mask", "feats", "quality"}


def _spy(monkeypatch, calls, backend, *names):
    """Wrap ``names`` on ``backend`` to append each call's name to
    ``calls``."""
    for name in names:
        real = getattr(backend, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(backend, name, spy)


@pytest.mark.parametrize("wiring", ["gui", "oracles", "no_person"])
def test_gui_wiring_dispatches_through_one_rule(wiring, monkeypatch, pair,
                                                person_pair):
    """The GUI wraps its face backend (the recovery facade) and its person
    detector in LazyBackend. The one dispatch rule still takes the combined
    step for them and returns the unwrapped backends' results; backends
    without it (the test oracles, or no person detector) get a
    ``submit_batch`` each and the same ``(faces, persons or None)`` pair."""
    frames = _frames_with_persons()
    valid = np.array([True, True, True, False])
    idxs = np.arange(4)
    calls = []
    if wiring == "oracles":
        sv = SimpleNamespace(truth={
            0: [FacePlacement(0, 1, (20, 10, 80, 90))],
            1: [FacePlacement(1, 2, (90, 40, 150, 115))]})
        face, person = TB.OracleBackend(sv), TB.OraclePersonBackend(sv)
        want = (face.extract_batch(frames, valid, idxs),
                person.detect_batch(frames, valid, idxs))
        _spy(monkeypatch, calls, face, "submit_batch")
        _spy(monkeypatch, calls, person, "submit_batch")
        expect = ["submit_batch", "submit_batch"]
    else:
        _, tb = pair
        _, tp = person_pair
        face = TR.RecoveringFaceBackend(
            tb, TR.RecoveryPolicy(rot_adaptive=False))
        person = tp if wiring == "gui" else None
        if person is None:
            want = (tb.submit_batch(frames, valid)(), None)
        else:
            want = tb.submit_wire_with_person(tp, frames, valid)()
        _spy(monkeypatch, calls, tb, "submit_batch",
             "submit_wire_with_person")
        expect = ["submit_wire_with_person" if person else "submit_batch"]
    lazy_face = TB.LazyBackend(lambda: face)
    lazy_person = None if person is None else TB.LazyBackend(lambda: person)
    fetch = TB.submit_faces_and_persons(lazy_face, lazy_person, frames,
                                        valid, idxs)
    assert calls == expect
    got = fetch()
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], atol=1e-5,
                                   err_msg=k)
    assert got[0]["mask"].any()
    if want[1] is None:
        assert got[1] is None
        return
    for k in ("boxes", "scores", "mask"):
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
    assert got[1]["mask"].any()
