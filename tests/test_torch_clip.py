"""The CLIP ViT tower of the torch port against the JAX package's, and the
backends built on it: ``ops/preprocess.resize_bicubic`` and
``normalize_clip``, ``models/clip_vit.ClipViT`` and ``encode_images``,
``bridge.load_clip``, ``ClipReidBackend``, and the CLIP-face and
YOLOv8-face branches of ``ScrfdArcFaceBackend``.

fp32 on both sides, inputs from a numpy seed, weights bridged from the JAX
variables (the bundled ``clip_reid_s`` and ``yolo_face_tiny`` checkpoints,
or the JAX model's random init). Tolerances: resize and normalisation
≤ 1e-4 on values in [0, 1] (or that times 255 on pixel values), tower
outputs and embeddings ≤ 1e-4; backends: identical valid slots, boxes and
landmarks ≤ 1e-3 px, feats cosine ≥ 0.9999.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.models import arcface as JAF  # noqa: E402
from person_capture_tpu.models import clip_vit as JC  # noqa: E402
from person_capture_tpu.models import scrfd as JSD  # noqa: E402
from person_capture_tpu.models import yolov8 as JY  # noqa: E402
from person_capture_tpu.models.zoo import resolve_weights  # noqa: E402
from person_capture_tpu.ops import preprocess as JP  # noqa: E402
from person_capture_tpu.pipeline import backends as JB  # noqa: E402
from person_capture_tpu_torch.models import arcface as TAF  # noqa: E402
from person_capture_tpu_torch.models import clip_vit as TC  # noqa: E402
from person_capture_tpu_torch.models import scrfd as TSD  # noqa: E402
from person_capture_tpu_torch.models import yolov8 as TY  # noqa: E402
from person_capture_tpu_torch.models.bridge import load_clip  # noqa: E402
from person_capture_tpu_torch.ops import preprocess as TP  # noqa: E402
from person_capture_tpu_torch.pipeline import backends as TB  # noqa: E402
from test_torch_backend import _frames  # noqa: E402

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("out", [
    (31, 40),      # downscale both axes (antialiased)
    (75, 40),      # one axis kept, one shrunk
    (150, 202),    # upscale
    (224, 224),    # the ViT-L-14 chip upscale's ratio, non-square source
    (96, 300),     # one axis shrunk, one grown
])
def test_resize_bicubic(out):
    """Keys cubic (a = -0.5), half-pixel centres, antialiased when
    shrinking, edge weights renormalised — jax.image.resize("cubic")."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 75, 101, 3)).astype(np.float32)
    want = np.asarray(JP.resize_bicubic(jnp.asarray(img), *out))
    got = TP.resize_bicubic(_t(img), *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_normalize_clip():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TP.normalize_clip(_t(img)).numpy(),
        np.asarray(JP.normalize_clip(jnp.asarray(img))), atol=ATOL)


def _pair(name):
    """(flax model, variables, bridged torch module) for one config: the
    bundled ReID checkpoint for clip_reid_s, the JAX random init else."""
    cfg = JC.CONFIGS[name]
    model, variables = JC.init_clip(jax.random.PRNGKey(3), cfg,
                                    dtype=jnp.float32)
    if name == "clip_reid_s":
        variables = resolve_weights("auto", "clip_reid_s")
    tm = load_clip(TC.ClipViT(TC.CONFIGS[name]).eval(), variables)
    return model, variables, tm


@pytest.fixture(scope="module", params=["clip_tiny", "clip_reid_s"])
def tower(request):
    return _pair(request.param)


def test_clip_vit_matches_flax(tower):
    model, variables, tm = tower
    s = model.cfg.image_size
    x = np.random.default_rng(0).normal(size=(3, s, s, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert got.shape == (3, model.cfg.embed_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encode_images_on_face_chips(tower):
    """112×112 aligned face chips, as the CLIP-face branch feeds them:
    downscaled to 32 (clip_tiny) or 96 (clip_reid_s) and normalised."""
    model, variables, tm = tower
    chips = np.random.default_rng(4).integers(0, 256, (5, 112, 112, 3))
    chips = chips.astype(np.float32)
    want = np.asarray(JC.encode_images(model, variables, jnp.asarray(chips)))
    got = TC.encode_images(tm, _t(chips)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_encode_images_aspect_crop():
    """A non-square batch: shortest side to S with int() floors, centre
    crop at round((n - S) / 2)."""
    model, variables, tm = _pair("clip_tiny")
    crops = np.random.default_rng(5).integers(0, 256, (2, 45, 71, 3))
    crops = crops.astype(np.float32)
    want = np.asarray(JC.encode_images(model, variables, jnp.asarray(crops)))
    got = TC.encode_images(tm, _t(crops)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_load_clip_is_strict():
    _, variables, _ = _pair("clip_tiny")
    missing = {"params": {**variables["params"]}}
    del missing["params"]["proj"]
    with pytest.raises(KeyError, match="proj"):
        load_clip(TC.ClipViT(TC.TINY), missing)
    extra = {"params": {**variables["params"], "stray": np.zeros(3)}}
    with pytest.raises(KeyError, match="stray"):
        load_clip(TC.ClipViT(TC.TINY), extra)


def test_random_init_is_seeded_and_flax_shaped():
    a = TC.random_init(TC.ClipViT(TC.TINY), torch.Generator().manual_seed(7))
    b = TC.random_init(TC.ClipViT(TC.TINY), torch.Generator().manual_seed(7))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert torch.all(a.ln_pre.weight == 1) and torch.all(a.blocks[0].fc.bias
                                                         == 0)
    assert abs(float(a.pos_embed.detach().std()) - 0.02) < 0.005


@pytest.fixture(scope="module")
def reid_pair():
    w = resolve_weights("auto", "clip_reid_s")
    return (JB.ClipReidBackend(cfg=JC.REID_S, dtype=jnp.float32, weights=w),
            TB.ClipReidBackend(cfg=TC.REID_S, dtype=torch.float32, weights=w,
                               device="cpu"))


def test_clip_reid_backend_extract(reid_pair):
    """Crops of mixed aspect (host bicubic of the shortest side, centre
    crop), 19 of them: one full chunk of 16 and one padded chunk."""
    jr, tr = reid_pair
    assert (tr.batch, tr.embed_dim, tr.dtype) == (16, 128, torch.float32)
    rng = np.random.default_rng(6)
    shapes = [(200, 80), (96, 96), (50, 120), (301, 300), (40, 41)]
    crops = [rng.integers(0, 256, (*shapes[i % 5], 3), np.uint8)
             for i in range(19)]
    want = jr.extract(crops)
    got = tr.extract(crops)
    assert got.shape == want.shape == (19, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tr.extract([]).shape == (0, 128)


def _check_face(got, want, min_faces):
    mask = want["mask"]
    np.testing.assert_array_equal(got["mask"], mask)
    assert mask.sum() >= min_faces
    for key in ("boxes", "kps"):
        np.testing.assert_allclose(got[key][mask], want[key][mask],
                                   atol=1e-3)
    assert got["feats"].shape == want["feats"].shape
    cos = (got["feats"][mask] * want["feats"][mask]).sum(-1)
    assert cos.min() >= 0.9999, cos


def test_clip_face_backend():
    """use_arcface=False: the aligned 112×112 chips go through the CLIP
    tower (clip_tiny, the JAX backend's random variables bridged in), and
    the packed output is 17 + 16 wide."""
    kw = dict(det_size=160, score_thresh=0.3, max_faces=4,
              scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
              use_arcface=False)
    jb = JB.ScrfdArcFaceBackend(JSD.SCRFD_2_5G, JAF.SYNTH_R18,
                                clip_face_cfg=JC.TINY, dtype=jnp.float32,
                                **kw)
    tb = TB.ScrfdArcFaceBackend(TSD.SCRFD_2_5G, TAF.SYNTH_R18,
                                clip_face_cfg=TC.TINY,
                                clip_face_weights=jb.clip_vars,
                                dtype=torch.float32, device="cpu", **kw)
    assert tb.embed_dim == jb.embed_dim == 16 and tb.arcface_model is None
    frames = _frames()
    valid = np.array([True, True, True, False])
    got = tb.extract_batch(frames, valid)
    _check_face(got, jb.extract_batch(frames, valid), min_faces=3)
    assert got["feats"].shape == (4, 4, 16)


def test_yolov8_face_backend():
    """A YoloConfig with a 5-point head as the face detector (the bundled
    yolo_face_tiny weights), the rest of the chain unchanged."""
    kw = dict(det_size=160, score_thresh=0.3, max_faces=4,
              scrfd_weights=resolve_weights("auto", "yolo_face_tiny"),
              arcface_weights=resolve_weights("auto", "arcface_synth"))
    jb = JB.ScrfdArcFaceBackend(JY.TINY_FACE, JAF.SYNTH_R18,
                                dtype=jnp.float32, **kw)
    tb = TB.ScrfdArcFaceBackend(TY.TINY_FACE, TAF.SYNTH_R18,
                                dtype=torch.float32, device="cpu", **kw)
    frames = _frames()
    valid = np.array([True, True, True, False])
    _check_face(tb.extract_batch(frames, valid),
                jb.extract_batch(frames, valid), min_faces=3)
    with pytest.raises(ValueError, match="multiple of 32"):
        TB.ScrfdArcFaceBackend(TY.TINY_FACE, TAF.SYNTH_R18, det_size=100,
                               device="cpu")
