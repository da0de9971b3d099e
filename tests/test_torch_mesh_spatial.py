"""The spatially sharded full-frame detect
(``parallel/mesh.build_sharded_fullframe_detect``) against the JAX
package's on its 8-device CPU mesh, fp32.

At the shapes of the JAX package's ``tests/test_sharded_backend.py``
spatial case (a slow-tier test, so Tier-1 runs the JAX function only
here): SCRFD TINY with its bundled weights, det 128 on ``data:2,model:4``
(slabs of 32 rows: the stride-32 map is one row a slab), 4 canvases of
that test's drawn faces. Masks identical, scores ≤ 1e-4 and boxes ≤ 1e-2
(that test's tolerances) against JAX's sharded detect; against the port's
unsharded ``detect_faces`` on the same weights, masks identical, scores
≤ 1e-5 and boxes ≤ 1e-5 relative.

Also: a canvas whose only face lies inside one slab, which a per-slab
GroupNorm scores otherwise (shown by summing each slab's own moments);
det sizes whose slabs are no whole number of 32 rows (160 over
``model:4``: slabs of 64, 32, 32 and 32 rows; 96: one slab empty), held
to JAX's function at that size; and a size that does not divide over the
axis, which JAX refuses and the port refuses with a ``ValueError`` naming
the setting.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.models import scrfd as JSD  # noqa: E402
from person_capture_tpu.parallel import mesh as JM  # noqa: E402
from person_capture_tpu_torch.models import scrfd as SD  # noqa: E402
from person_capture_tpu_torch.models.bridge import load_scrfd  # noqa: E402
from person_capture_tpu_torch.models.zoo import resolve_weights  # noqa: E402
from person_capture_tpu_torch.parallel import mesh as TM  # noqa: E402
from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    FacePlacement, draw_face)

SIZE, FACES, THRESH = 128, 4, 0.45


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return resolve_weights("auto", "scrfd_tiny")


def _canvases(size=SIZE):
    """The JAX test's 4 canvases: background 70, one drawn face of 36-48
    px each (rng 3)."""
    rng = np.random.default_rng(3)
    frames = np.full((4, size, size, 3), 70, np.uint8)
    for i in range(4):
        s = float(rng.uniform(36, 48))
        x = float(rng.uniform(4, size - s - 4))
        y = float(rng.uniform(4, size - s - 4))
        draw_face(frames[i], FacePlacement(0, 0, (x, y, x + s, y + s)))
    return frames.astype(np.float32)


def _jax_detect(weights, spec, canvases):
    mesh = JM.make_mesh(spec, devices=jax.devices("cpu")[:8])
    run = JM.build_sharded_fullframe_detect(
        mesh, scrfd_cfg=JSD.TINY, det_size=canvases.shape[1],
        max_faces=FACES, seed=0, dtype=jnp.float32, scrfd_vars=weights)
    out = run(canvases, np.ones(len(canvases), np.float32),
              score_thresh=THRESH)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_detect(weights, spec, canvases):
    run = TM.build_sharded_fullframe_detect(
        TM.make_mesh(spec, device="cpu"), scrfd_cfg=SD.TINY,
        det_size=canvases.shape[1], max_faces=FACES, dtype=torch.float32,
        scrfd_vars=weights)
    out = run(canvases, np.ones(len(canvases), np.float32),
              score_thresh=THRESH)
    return run, {k: v.numpy() for k, v in out.items()}


def _unsharded(weights, canvases):
    model = load_scrfd(SD.SCRFD(SD.TINY), weights).eval()
    out = SD.detect_faces(model, torch.from_numpy(canvases),
                          torch.ones(len(canvases)), THRESH, FACES)
    return {k: v.numpy() for k, v in out.items()}


def _assert_like_jax(got, want):
    mask = want["mask"]
    np.testing.assert_array_equal(got["mask"], mask)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got["boxes"][mask], want["boxes"][mask],
                               atol=1e-2, rtol=0)


def _assert_unsharded(got, want):
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def jax_run(weights):
    return _jax_detect(weights, "data:2,model:4", _canvases())


@pytest.fixture(scope="module")
def port_run(weights):
    return _port_detect(weights, "data:2,model:4", _canvases())


def test_spatial_detect_splits_the_canvas(port_run):
    run, out = port_run
    assert run.spatial and run.mesh.shape == {"data": 2, "model": 4}
    assert out["boxes"].shape == (4, FACES, 4)
    assert out["kps"].shape == (4, FACES, 5, 2)
    assert out["mask"].any(1).all(), "the drawn faces must be found"


def test_spatial_detect_matches_jax(jax_run, port_run):
    _assert_like_jax(port_run[1], jax_run)


def test_spatial_detect_matches_unsharded(weights, port_run):
    _assert_unsharded(port_run[1], _unsharded(weights, _canvases()))


def test_no_spatial_axis_is_data_parallel(weights):
    """A mesh without the spatial axis runs each replica's canvases whole
    (``run.spatial`` False), as the JAX function's."""
    run, out = _port_detect(weights, "data:2", _canvases())
    assert not run.spatial
    _assert_unsharded(out, _unsharded(weights, _canvases()))


def _one_face_in_one_slab():
    """One canvas whose only face (40 px at rows 12-52) lies inside the
    first of two 64-row slabs; the other slab is flat background."""
    canvas = np.full((1, SIZE, SIZE, 3), 70, np.uint8)
    draw_face(canvas[0], FacePlacement(0, 0, (40, 12, 80, 52)))
    return canvas.astype(np.float32)


def test_groupnorm_takes_the_whole_map(weights, monkeypatch):
    """The head's GroupNorm needs the moments of the whole map: with them
    the two-slab detect is the unsharded one; with each slab's own (the
    sum over the row replaced by the slab's own sum, scaled to the row)
    the face's scores move far past the tolerance."""
    canvas = _one_face_in_one_slab()
    want = _unsharded(weights, canvas)
    assert want["mask"].any(), "the face must be found"
    _assert_unsharded(_port_detect(weights, "data:1,model:2", canvas)[1],
                      want)
    monkeypatch.setattr(TM.RowComm, "all_reduce",
                        lambda self, parts: [p * len(self.devices)
                                             for p in parts])
    per_slab = _port_detect(weights, "data:1,model:2", canvas)[1]
    moved = np.abs(per_slab["scores"] - want["scores"]).max()
    assert moved > 1e-2 or (per_slab["mask"] != want["mask"]).any(), moved


@pytest.mark.parametrize("size", [160, 96], ids=["slabs_64_32_32_32",
                                                 "one_slab_empty"])
def test_uneven_slabs_match_jax(weights, size):
    """Slabs of whole rows of 32 as evenly as they go: the JAX function's
    detections at a size whose slabs are not, and the unsharded ones."""
    canvases = _canvases(size)
    want = _jax_detect(weights, "data:1,model:4", canvases)
    assert want["mask"].any()
    got = _port_detect(weights, "data:1,model:4", canvases)[1]
    _assert_like_jax(got, want)
    _assert_unsharded(got, _unsharded(weights, canvases))


def test_size_that_does_not_divide_is_refused(weights):
    """det 128 over ``model:3``: JAX refuses the sharding, the port says
    which setting to change."""
    with pytest.raises(ValueError, match="divisible by 3"):
        _jax_detect(weights, "data:1,model:3", _canvases())
    with pytest.raises(ValueError,
                       match=r"face_fullframe_imgsz / --det-size 128 .*"
                             r"'model' axis of size 3"):
        _port_detect(weights, "data:1,model:3", _canvases())
