"""YOLOv8 of the torch port against the flax model and the JAX package's
decode, detection and person backend, fp32 on the CPU.

Tolerances: rtol/atol 1e-4 on the raw level maps (the same convolutions
summed in another order) and on decoded boxes, keypoints and scores (atol
1e-3 px for boxes at 640); identical detection slots and masks — including
all-equal scores, where only the top-k and NMS tie order decide.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.models import yolov8 as JY  # noqa: E402
from person_capture_tpu.models.zoo import resolve_weights  # noqa: E402
from person_capture_tpu.ops.preprocess import normalize_yolo  # noqa: E402
from person_capture_tpu.pipeline import backends as JB  # noqa: E402
from person_capture_tpu_torch.models import bridge  # noqa: E402
from person_capture_tpu_torch.models import yolov8 as TY  # noqa: E402
from person_capture_tpu_torch.ops import preprocess as TP  # noqa: E402
from person_capture_tpu_torch.pipeline import backends as TB  # noqa: E402
from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    FacePlacement, draw_person)

TOL = 1e-4


def _pair(name, variables=None):
    """The flax model and the port's, filled with ``variables`` (default:
    the bundled checkpoint)."""
    if variables is None:
        variables = resolve_weights("auto", name)
    tm = bridge.load_yolov8(TY.YoloV8(TY.CONFIGS[name]).eval(), variables)
    return JY.YoloV8(JY.CONFIGS[name]), variables, tm


def _tied_variables(name):
    """Every weight 0 (BatchNorm var 1), class bias 0: every cell of every
    level scores sigmoid(0) = 0.5 with the same box shape — a batch of
    exact ties."""
    v = resolve_weights("auto", name)

    def zero(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] == "var" or (keys[-1] == "scale"
                                 and "BatchNorm_0" in keys):
            return np.ones_like(leaf)
        return np.zeros_like(leaf)

    return jax.tree_util.tree_map_with_path(zero, v)


def _random_variables(name, seed=3):
    """He-normal kernels, random biases and BatchNorm statistics (var in
    0.5..1.5) in the bundled checkpoint's tree."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = getattr(path[-1], "key", "")
        if key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), leaf.shape) \
                .astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw,
                                            resolve_weights("auto", name))


def _person_frames(n=3, size=160):
    rng = np.random.default_rng(0)
    out = np.clip(rng.integers(30, 70, (n, size, size, 3))
                  + rng.integers(0, 12, (n, size, size, 1)), 0,
                  255).astype(np.uint8)
    draw_person(out[0], FacePlacement(0, 0, (60, 20, 76, 38)))
    draw_person(out[1], FacePlacement(1, 1, (20, 30, 32, 44)))
    draw_person(out[1], FacePlacement(1, 2, (110, 40, 124, 56)))
    return out


def test_normalize_yolo():
    x = np.random.default_rng(1).integers(0, 256, (2, 5, 7, 3), np.uint8)
    np.testing.assert_allclose(TP.normalize_yolo(torch.from_numpy(x)).numpy(),
                               np.asarray(normalize_yolo(jnp.asarray(x))),
                               atol=1e-7)


@pytest.mark.parametrize("name", ["yolo_tiny", "yolov8n", "yolo_face_tiny"])
def test_level_maps(name):
    """TINY with random weights, YOLOv8n at full width and the tiny face
    model (pose head) with their bundled weights, on a 64×64 input."""
    jm, variables, tm = _pair(
        name, _random_variables(name) if name == "yolo_tiny" else None)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(got) == len(want) == 3
    for wl, gl in zip(want, got):
        assert len(wl) == len(gl)
        for w, g in zip(wl, gl):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w), rtol=TOL, atol=TOL)


def test_check_det_size():
    TY.check_det_size(TY.YOLOV8N, 640)
    with pytest.raises(ValueError, match="multiple of 32"):
        TY.check_det_size(TY.YOLOV8N, 100)
    with pytest.raises(ValueError, match="multiple of 32"):
        TB.YoloPersonBackend(cfg=TY.TINY, det_size=48, device="cpu")


def test_decode_level_and_kpts():
    rng = np.random.default_rng(4)
    box = rng.normal(size=(2, 5, 7, 64)).astype(np.float32)
    cls = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    kps = rng.normal(size=(2, 5, 7, 15)).astype(np.float32)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    wb, ws = JY.decode_level(jnp.asarray(box), jnp.asarray(cls), 16, 16)
    gb, gs = TY.decode_level(nchw(box), nchw(cls), 16, 16)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=TOL, atol=TOL)
    wp, wv = JY.decode_kpts_level(jnp.asarray(kps), 8, 5, 3)
    gp, gv = TY.decode_kpts_level(nchw(kps), 8, 5, 3)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=TOL, atol=TOL)


def _held(got, want, keys, atol):
    mask = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy()[mask],
                                   np.asarray(want[k])[mask], atol=atol,
                                   err_msg=k)
    return mask


@pytest.mark.parametrize("tied", [False, True])
def test_detect_persons(tied):
    """Bundled yolov8n on drawn persons, and the all-ties model: same slots
    in the same order; boxes scaled by 1/det_scale and clamped to
    ``clip_hw``."""
    size = 160
    jm, variables, tm = _pair(
        "yolov8n", _tied_variables("yolov8n") if tied else None)
    frames = _person_frames(size=size).astype(np.float32)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    kw = dict(conf=0.3, max_det=8, clip_hw=(100, 150))
    want = JY.detect_persons(jm, variables, jnp.asarray(frames),
                             jnp.asarray(scales), **kw)
    got = TY.detect_persons(tm, torch.from_numpy(frames),
                            torch.from_numpy(scales), **kw)
    mask = _held(got, want, ("scores",), TOL)
    if tied:
        assert mask.all()
        # the clamp holds boxes that reach past the 150×100 frame
        assert (got["boxes"][..., 2] == 150).any()
        assert (got["boxes"][..., 3] == 100).any()
        np.testing.assert_array_equal(got["boxes"].numpy(),
                                      np.asarray(want["boxes"]))
    else:
        assert mask[0].sum() >= 1 and mask[1].sum() >= 2
        np.testing.assert_allclose(got["boxes"].numpy()[mask],
                                   np.asarray(want["boxes"])[mask],
                                   rtol=TOL, atol=1e-3)
    assert (got["boxes"].numpy() <= np.array([150, 100, 150, 100])).all()


@pytest.mark.parametrize("tied", [False, True])
def test_detect_faces_yolo(tied):
    size = 160
    jm, variables, tm = _pair(
        "yolo_face_tiny", _tied_variables("yolo_face_tiny") if tied else None)
    frames = _person_frames(size=size).astype(np.float32)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    want = JY.detect_faces_yolo(jm, variables, jnp.asarray(frames),
                                jnp.asarray(scales), 0.2, 8)
    got = TY.detect_faces_yolo(tm, torch.from_numpy(frames),
                               torch.from_numpy(scales), 0.2, 8)
    mask = _held(got, want, ("scores", "boxes", "kps"), 1e-3)
    assert mask.any(axis=1).all() if tied else mask.any()


def test_person_backend_detect_batch():
    w = resolve_weights("auto", "yolov8n")
    kw = dict(det_size=160, conf=0.3, max_det=4, weights=w)
    jb = JB.YoloPersonBackend(cfg=JY.YOLOV8N, dtype=jnp.float32, **kw)
    tb = TB.YoloPersonBackend(cfg=TY.YOLOV8N, dtype=torch.float32,
                              device="cpu", **kw)
    assert (tb.det_size, tb.conf, tb.max_det) == (jb.det_size, jb.conf,
                                                  jb.max_det)
    frames = _person_frames()[:, :120]          # letterboxed 160×120
    valid = np.array([True, True, False])
    want = jb.detect_batch(frames, valid)
    fetch = tb.submit_batch(frames, valid)
    valid[:] = False             # the fetcher owns its copy of the mask
    got = fetch()
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"][1].sum() >= 2 and not want["mask"][2].any()
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k][want["mask"]],
                                   want[k][want["mask"]], atol=1e-3)


def test_person_backend_defaults():
    """Like the JAX backend: det 640, 16 slots, bf16 unless given."""
    b = TB.YoloPersonBackend(cfg=TY.TINY, device="cpu")
    assert (b.det_size, b.max_det, b.dtype) == (640, 16, torch.bfloat16)
    assert next(b.model.parameters()).dtype == torch.bfloat16
