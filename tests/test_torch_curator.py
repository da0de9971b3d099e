"""The torch port's curation against the JAX package's: ``core/hashing``
(host functions and the batched torch pHash), the native host ops,
``curator.Curator`` (``describe`` and ``run``) with real backends on both
sides, and the curator CLI.

fp32 on both sides (the CLIs' backends default to bf16; the CLI test holds
them in fp32), the bundled SCRFD-2.5G, ArcFace and ``clip_reid_s`` weights,
and a pool of synthetic crops drawn from a numpy seed. Tolerances: hashes
bit-identical; per-item face distance ≤ 1e-4, the other host features and
the pHash, ratio and category identical, CLIP embeddings ≤ 1e-4; the
selection list, scenes and ``selection_debug.csv`` ranks identical, with
scores ≤ 1e-5.
"""

import csv
import os

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from person_capture_tpu import native as JN  # noqa: E402
from person_capture_tpu.core import bank as JBK  # noqa: E402
from person_capture_tpu.core import hashing as JH  # noqa: E402
from person_capture_tpu.curator import __main__ as JCLI  # noqa: E402
from person_capture_tpu.curator import core as JCU  # noqa: E402
from person_capture_tpu.models import arcface as JAF  # noqa: E402
from person_capture_tpu.models import clip_vit as JC  # noqa: E402
from person_capture_tpu.models import scrfd as JSD  # noqa: E402
from person_capture_tpu.models.zoo import resolve_weights  # noqa: E402
from person_capture_tpu.pipeline import backends as JB  # noqa: E402
from person_capture_tpu.video.synthetic import (FacePlacement,  # noqa: E402
                                                draw_face)
from person_capture_tpu_torch import native as TN  # noqa: E402
from person_capture_tpu_torch.core import bank as TBK  # noqa: E402
from person_capture_tpu_torch.core import hashing as TH  # noqa: E402
from person_capture_tpu_torch.curator import __main__ as TCLI  # noqa: E402
from person_capture_tpu_torch.curator import core as TCU  # noqa: E402
from person_capture_tpu_torch.models import arcface as TAF  # noqa: E402
from person_capture_tpu_torch.models import clip_vit as TC  # noqa: E402
from person_capture_tpu_torch.models import scrfd as TSD  # noqa: E402
from person_capture_tpu_torch.pipeline import backends as TB  # noqa: E402
from test_torch_slice import _float32_default  # noqa: E402

DET = 160


def _images(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (rng.integers(20, 90), rng.integers(20, 90),
                                 3), np.uint8) for _ in range(n)]
    return out + [np.full((40, 40, 3), 77, np.uint8)]


def test_host_hashing_matches_jax():
    np.testing.assert_array_equal(TH._dct_matrix(32), JH._dct_matrix(32))
    for img in _images():
        assert TH.phash_bits(img) == JH.phash_bits(img)
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(TH._area_resize_32(gray),
                                      JH._area_resize_32(gray))
        np.testing.assert_array_equal(TH.dct2(gray), JH.dct2(gray))
    assert TH.phash_bits(np.zeros((0, 0, 3), np.uint8)) == 0
    bits = np.random.default_rng(1).integers(0, 2, 64)
    assert TH.pack_bits(bits) == JH.pack_bits(bits)
    assert TH.phash_similarity(0b1011, 0b0110) \
        == JH.phash_similarity(0b1011, 0b0110)


def _gray32(n=9, seed=2):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 255, (n, 32, 32)).astype(np.float32)
    g[-1] = 128.0                           # a flat image: all ties
    return g


def test_native_matches_jax():
    """Both packages build the same hostops.cpp with the same flags, so a
    pool hashes alike; the port's library lands in build/native."""
    assert TN.available() == JN.available()
    if TN.available():
        assert TN.library_path().startswith(TN.BUILD_DIR)
        assert os.path.isfile(TN.library_path())
    g = _gray32()
    for zero_dc in (True, False):
        np.testing.assert_array_equal(TN.phash64_batch(g, zero_dc),
                                      JN.phash64_batch(g, zero_dc))
    # the curator's numpy pHash agrees with the native one (away from the
    # round-off ties of a flat image, where neither is meaningful)
    for img in _images()[:-1]:
        g32 = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), (32, 32),
                         interpolation=cv2.INTER_AREA).astype(np.float32)
        assert int(TN.phash64_batch(g32[None])[0]) == TCU.phash64(img)
    a = np.random.default_rng(3).integers(0, 2 ** 63, 7, dtype=np.uint64)
    b = a[::-1].copy() ^ np.uint64(0xF0F0)
    np.testing.assert_array_equal(TN.hamming_matrix(a, b),
                                  JN.hamming_matrix(a, b))
    y = (np.arange(8 * 12, dtype=np.uint16).reshape(8, 12) * 500) << 6
    uv = (np.arange(4 * 6 * 2, dtype=np.uint16).reshape(4, 12) * 900) << 6
    for got, want in zip(TN.p010_repack(y, uv), JN.p010_repack(y, uv)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="32, 32"):
        TN.phash64_batch(np.zeros((2, 16, 16), np.float32))


def test_batched_phash_matches_jnp():
    """``phash_bits_batch`` against ``phash_bits_batch_jnp``: the median of
    64 coefficients averages the 32nd and 33rd, as jnp.median does. (Not
    on a flat image: there every AC coefficient is round-off, whose sign
    follows the summation order.)"""
    g = _gray32(17)[:-1]
    want = np.asarray(JH.phash_bits_batch_jnp(jnp.asarray(g)))
    got = TH.phash_bits_batch(torch.from_numpy(g)).numpy()
    assert got.dtype == np.uint8 and got.shape == (16, 64)
    np.testing.assert_array_equal(got, want)
    # bit order as phash_bits: a host hash of the same block packs alike
    assert TH.pack_bits(got[0]) == JH.pack_bits(want[0])
    d_want = np.asarray(JH.phash_hamming_matrix_jnp(jnp.asarray(want),
                                                    jnp.asarray(want[:5])))
    d_got = TH.phash_hamming_matrix(torch.from_numpy(got),
                                    torch.from_numpy(got[:5])).numpy()
    np.testing.assert_array_equal(d_got, d_want)


def _make_pool(d):
    """Crops as a run leaves them: f%08d.jpg, a few scenes, faces of the
    reference identity at several sizes, one of another identity, one
    with none."""
    rng = np.random.default_rng(0)
    d.mkdir()
    k = 0
    for scene in range(3):
        bg = rng.integers(40, 200, 3)
        for j in range(5):
            h, w = (240, 160) if j != 4 else (160, 160)
            img = np.full((h, w, 3), bg, np.uint8)
            img += rng.integers(0, 8, img.shape).astype(np.uint8)
            if j < 4 or scene == 0:
                size = 50 + 14 * j
                x0, y0 = 80 - size // 2 + 4 * scene, 30 + 6 * j
                ident = 1 if (scene, j) == (2, 3) else 0
                draw_face(img, FacePlacement(k, ident, (x0, y0, x0 + size,
                                                        y0 + size)))
            cv2.imwrite(str(d / f"f{(k * 6 + scene * 90):08d}.jpg"), img)
            k += 1
    ref = np.full((200, 200, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (40, 40, 160, 160)))
    return ref


def _backends():
    kw = dict(det_size=DET, score_thresh=0.3, max_faces=4,
              scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
              arcface_weights=resolve_weights("auto", "arcface_synth"))
    rw = resolve_weights("auto", "clip_reid_s")
    jax_side = (JB.ScrfdArcFaceBackend(JSD.SCRFD_2_5G, JAF.SYNTH_R18,
                                       dtype=jnp.float32, **kw),
                JB.ClipReidBackend(cfg=JC.REID_S, dtype=jnp.float32,
                                   weights=rw))
    torch_side = (TB.ScrfdArcFaceBackend(TSD.SCRFD_2_5G, TAF.SYNTH_R18,
                                         dtype=torch.float32, device="cpu",
                                         **kw),
                  TB.ClipReidBackend(cfg=TC.REID_S, dtype=torch.float32,
                                     weights=rw, device="cpu"))
    return jax_side, torch_side


def _curate(CU, BK, B, face, clip, ref, pool, out):
    bank = BK.RefBank(cap=16)
    det = B.extract_single_image(face, ref)
    j = int(np.argmax(np.where(det["mask"][0], det["quality"][0], -1.0)))
    bank.update(det["feats"][0][j], float(det["quality"][0][j]))
    cur = CU.Curator(face, bank, clip_backend=clip, batch=4, canvas=DET)
    return cur.run(pool, out, max_images=8, dedup_hamm=5)


@pytest.fixture(scope="module")
def curated(tmp_path_factory):
    d = tmp_path_factory.mktemp("curate")
    ref = _make_pool(d / "pool")
    (jf, jc), (tf, tc) = _backends()
    want = _curate(JCU, JBK, JB, jf, jc, ref, str(d / "pool"),
                   str(d / "jax"))
    got = _curate(TCU, TBK, TB, tf, tc, ref, str(d / "pool"),
                  str(d / "torch"))
    return d, want, got


def test_describe_matches_jax(curated):
    _, want, got = curated
    assert len(got["items"]) == len(want["items"]) == 15
    found = 0
    for g, w in zip(got["items"], want["items"]):
        assert g.path == w.path
        assert (g.phash, g.ratio, TCU.categorize(g)) \
            == (w.phash, w.ratio, JCU.categorize(w))
        for key in ("ts", "sharpness", "exposure", "wmark", "meta"):
            assert getattr(g, key) == getattr(w, key), key
        assert abs(g.face_fd - w.face_fd) <= 1e-4
        if w.face_feat is None:
            assert g.face_feat is None
            continue
        found += 1
        np.testing.assert_allclose(g.face_box, w.face_box, atol=1e-2)
        np.testing.assert_allclose((g.face_frac, g.yaw, g.roll),
                                   (w.face_frac, w.yaw, w.roll), atol=1e-3)
        assert abs(g.face_quality - w.face_quality) \
            <= 1e-3 * max(1.0, abs(w.face_quality))
        assert float(np.dot(g.face_feat, w.face_feat)) >= 0.9999
        np.testing.assert_allclose(g.bg_clip, w.bg_clip, atol=1e-4)
    assert found >= 10


def _debug_rows(path):
    with open(os.path.join(path, "selection_debug.csv")) as fh:
        return list(csv.DictReader(fh))


def test_run_selection_matches_jax(curated):
    d, want, got = curated
    strip = [os.path.basename(p) for p in got["selected"]]
    assert strip == [os.path.basename(p) for p in want["selected"]]
    assert 1 <= len(strip) <= 8
    assert [it.scene for it in got["items"]] \
        == [it.scene for it in want["items"]]
    for key in ("pool", "selected", "scenes", "scene_dedup_kept",
                "categories"):
        assert got["metrics"][key] == want["metrics"][key], key
    g_rows, w_rows = _debug_rows(d / "torch"), _debug_rows(d / "jax")
    assert len(g_rows) == len(w_rows) == len(strip)
    for g, w in zip(g_rows, w_rows):
        for key in ("rank", "file", "scene", "category", "is_profile"):
            assert (os.path.basename(g[key]) if key == "file" else g[key]) \
                == (os.path.basename(w[key]) if key == "file" else w[key])
        for key in ("quality", "redundancy", "mmr_score"):
            assert abs(float(g[key]) - float(w[key])) <= 1e-5, key
    for p in got["selected"]:
        assert os.path.isfile(p)


def test_curator_cli_matches_jax(curated, monkeypatch, capsys):
    """Both curator CLIs with ``--device cpu`` on the same pool, their
    backends held in fp32."""
    d = curated[0]
    for cls, dtype in ((JB.ScrfdArcFaceBackend, jnp.float32),
                       (JB.ClipReidBackend, jnp.float32),
                       (TB.ScrfdArcFaceBackend, torch.float32),
                       (TB.ClipReidBackend, torch.float32)):
        _float32_default(monkeypatch, cls, dtype)
    ref = str(d / "ref.png")
    img = np.full((200, 200, 3), 60, np.uint8)
    draw_face(img, FacePlacement(0, 0, (40, 40, 160, 160)))
    cv2.imwrite(ref, img)
    argv = ["--pool", str(d / "pool"), "--ref", ref, "--max", "6",
            "--device", "cpu", "--det-size", str(DET)]
    assert JCLI.main(argv + ["--out", str(d / "cli_jax")]) == 0
    assert TCLI.main(argv + ["--out", str(d / "cli_torch")]) == 0
    lines = capsys.readouterr().out.splitlines()
    summary = [ln for ln in lines if ln.startswith("selected ")]
    assert len(summary) == 2 and summary[0] == summary[1], summary
    got = sorted(os.listdir(d / "cli_torch"))
    assert got == sorted(os.listdir(d / "cli_jax"))
    assert any(f.endswith(".jpg") for f in got)
    assert [r["file"] for r in _debug_rows(d / "cli_torch")] \
        == [r["file"] for r in _debug_rows(d / "cli_jax")]


def test_curator_cli_device(monkeypatch, tmp_path):
    """``--device cuda`` is the default and raises without a card."""
    args = TCLI.build_parser().parse_args(["--pool", "P", "--out", "O"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCLI.main(["--pool", str(tmp_path), "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit):
        TCLI.build_parser().parse_args(["--pool", "P", "--out", "O",
                                        "--device", "tpu"])
