"""The face embedder of ``ScrfdArcFaceBackend`` embeds only the kept slots:
the slots the detector kept on valid frames are gathered into a batch of
``embed_bucket`` rows, embedded in one tower call and scattered back.

Held against the all-slots computation (every slot of every frame through
the tower, then masked), on the CPU in float32 with the bundled SCRFD
weights at det 160 and the tiny ArcFace, ViT and SigLIP towers:
- every slot the host reads (``mask & valid``) has the same mask, box and
  score, its features at cos ≥ 0.9999 and its quality at rtol 1e-3 (the
  tower runs the same chips in a batch of another size);
- a batch with no kept slot makes no tower call, and its features are
  zero;
- every batch size that reaches ``_encode`` is a bucket, and no chip of a
  frame with ``valid`` False is in it.

The ``cuda``-marked test holds the same on the card in bf16 at the
published ViT-L/14 and SigLIP So400m/14-384 widths (seeded weights). Run it
there with ``python -m pytest tests/test_torch_embed_kept.py -q
--noconftest -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from person_capture_tpu_torch.models import arcface as AF  # noqa: E402
from person_capture_tpu_torch.models import clip_vit as CV  # noqa: E402
from person_capture_tpu_torch.models import scrfd as SD  # noqa: E402
from person_capture_tpu_torch.models import siglip as SG  # noqa: E402
from person_capture_tpu_torch.models.zoo import resolve_weights  # noqa: E402
from person_capture_tpu_torch.ops.align import align_chips  # noqa: E402
from person_capture_tpu_torch.ops.quality import chip_quality  # noqa: E402
from person_capture_tpu_torch.pipeline.backends import (  # noqa: E402
    ScrfdArcFaceBackend, embed_bucket, pad_batch)
from person_capture_tpu_torch.utils.timing import (  # noqa: E402
    NULL_TIMER, StepTimer)
from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    FacePlacement, draw_face)

MAX_FACES = 4
TOWERS = {"arcface": None, "vit": CV.TINY, "siglip": SG.TINY}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores, and these tiny CPU runs gain
    nothing from more threads but contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _backend(tower, device="cpu", dtype=torch.float32, det_size=160,
             max_faces=MAX_FACES, seed=0):
    return ScrfdArcFaceBackend(
        SD.SCRFD_2_5G, AF.TINY, det_size=det_size, score_thresh=0.3,
        max_faces=max_faces, dtype=dtype, seed=seed,
        scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
        transfer_format="bgr", use_arcface=tower is None,
        clip_face_cfg=tower, device=device)


@pytest.fixture(scope="module")
def backends():
    return {name: _backend(cfg) for name, cfg in TOWERS.items()}


def _frames(n=6, h=120, w=160):
    """Drawn faces: one, two, none (noise), one, two, one a frame, each
    round of six moved 3 px down, so no two frames are alike."""
    out = np.full((n, h, w, 3), 55, np.uint8)
    boxes = [[(20, 10, 80, 90)], [(90, 40, 150, 115), (5, 5, 45, 55)], [],
             [(50, 30, 100, 95)], [(10, 20, 60, 80), (95, 25, 150, 100)],
             [(60, 15, 120, 95)]]
    for i in range(n):
        dy = 3 * (i // len(boxes))
        for j, (x1, y1, x2, y2) in enumerate(boxes[i % len(boxes)]):
            draw_face(out[i], FacePlacement(i, j, (x1, y1 + dy, x2, y2 + dy)))
    out[2] = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
    return out


def _all_slots(face, frames):
    """The all-slots computation: the first k slots of every frame aligned
    and embedded, the mask cut to those k, features and quality zero off
    the mask (``valid`` masks them on the host)."""
    bgr = face._upload(frames).float()
    f = face.max_faces
    with torch.inference_mode():
        det = face._detect_bgr(bgr)
        k = min(face.embed_slots or f, f)
        chips = align_chips(bgr, det["kps"][:, :k], det["mask"][:, :k])
        flat = chips.reshape(-1, *chips.shape[2:])
        feats = face._encode(flat).reshape(-1, k, face.embed_dim)
        quality = chip_quality(flat).reshape(-1, k)
    mask = det["mask"].cpu().numpy() & (np.arange(f) < k)
    feats = np.pad(feats.float().cpu().numpy(), ((0, 0), (0, f - k), (0, 0)))
    quality = np.pad(quality.cpu().numpy(), ((0, 0), (0, f - k)))
    return {"mask": mask, "boxes": det["boxes"].cpu().numpy(),
            "scores": det["scores"].cpu().numpy(),
            "feats": np.where(mask[..., None], feats, 0),
            "quality": np.where(mask, quality, 0),
            "chips": flat.cpu(), "k": k}


class _Spy:
    """Records every batch that reaches the backend's ``_encode``."""

    def __init__(self, face):
        self.face, self.batches = face, []
        self._encode = face._encode

    def __enter__(self):
        def encode(chips):
            self.batches.append(chips.detach().clone())
            return self._encode(chips)

        self.face._encode = encode
        return self

    def __exit__(self, *exc):
        del self.face._encode


# ---- the gathered path against the all-slots computation ----------------

CASES = {
    # 4 real frames padded to 6 by repeating the last: its faces are real
    "padding_frames": dict(real=4, batch=6, slots=0),
    # blank frames: the detector keeps nothing
    "no_face": dict(real=3, batch=3, slots=0, blank=True),
    # one slot a frame on frames that each hold a face: every slot kept
    "every_slot_kept": dict(real=2, batch=2, slots=1, pick=[0, 1]),
}


@pytest.mark.parametrize("tower", sorted(TOWERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_slots_match_the_all_slots_computation(backends, tower, case):
    face = backends[tower]
    spec = CASES[case]
    frames = _frames()
    if spec.get("blank"):
        frames = np.full_like(frames, 55)
    if "pick" in spec:
        frames = frames[spec["pick"]]
    arr, _, valid, _ = pad_batch(list(frames[:spec["real"]]), spec["batch"])
    face.embed_slots = spec["slots"]
    try:
        want = _all_slots(face, arr)
        got = face.extract_batch(arr, valid)
    finally:
        face.embed_slots = 0
    k = want["k"]
    read = want["mask"] & valid[:, None]
    np.testing.assert_array_equal(got["mask"], read)
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    np.testing.assert_array_equal(got["scores"], want["scores"])
    if case == "no_face":
        assert not read.any()
    else:
        assert read.sum() >= 2
    if case == "every_slot_kept":
        assert read[:, :k].all()
    if case == "padding_frames":
        assert want["mask"][~valid].any(), "padding frames hold no face"
    cos = (got["feats"][read] * want["feats"][read]).sum(-1)
    assert (cos >= 0.9999).all(), cos
    np.testing.assert_allclose(got["quality"][read], want["quality"][read],
                               rtol=1e-3)
    # every slot off the kept ones of valid frames carries zeros
    assert not got["feats"][~read].any()
    assert not got["quality"][~read].any()


def test_nothing_kept_makes_no_tower_call(backends):
    face = backends["vit"]
    frames = np.full((3, 120, 160, 3), 55, np.uint8)
    timer = StepTimer()
    face.timer = timer
    try:
        with _Spy(face) as spy:
            out = face.extract_batch(frames, np.ones(3, bool))
    finally:
        face.timer = NULL_TIMER
    assert spy.batches == []
    assert not out["mask"].any()
    assert not out["feats"].any() and not out["quality"].any()
    c = timer.counters()
    assert c["embed.calls_skipped"] == 1
    assert c["embed.slots"] == 3 * MAX_FACES
    assert "embed.chips" not in c
    assert "face.embed" not in timer.summary()


# ---- the buckets --------------------------------------------------------

@pytest.mark.parametrize("total", [1, 4, 8, 9, 24, 100, 1024])
def test_bucket_is_a_fixed_size_at_most_twice_the_kept(total):
    sizes = {8 * 2 ** i for i in range(12)} | {total}
    for n in range(1, total + 1):
        rows = embed_bucket(n, total)
        assert rows in sizes
        assert n <= rows <= total
        assert rows < 2 * max(n, 8)


def test_tower_sees_buckets_and_no_chip_of_an_invalid_frame(backends):
    """Every batch through ``_encode``: a bucket of at most b·k rows, below
    2·max(n, 8); its first n rows the kept chips of valid frames in slot
    order, the rest zero. The frames left out by ``valid`` hold faces of
    their own, so a gather that took them would show."""
    face = backends["arcface"]
    frames = _frames(12)
    k = MAX_FACES
    want = _all_slots(face, frames)
    chips = want["chips"].numpy()
    patterns = [np.array(v, bool) for v in
                ([1] * 12, [1, 0] * 6, [0, 1] * 6, [1] * 4 + [0] * 8,
                 [0] * 11 + [1])]
    for valid in patterns:
        read = (want["mask"][:, :k] & valid[:, None]).reshape(-1)
        off = (want["mask"][:, :k] & ~valid[:, None]).reshape(-1)
        n = int(read.sum())
        with _Spy(face) as spy:
            face.extract_batch(frames, valid)
        assert len(spy.batches) == 1, valid
        rows = spy.batches[0].numpy()
        assert rows.shape[0] == embed_bucket(n, frames.shape[0] * k)
        assert rows.shape[0] <= frames.shape[0] * k
        assert rows.shape[0] < 2 * max(n, 8)
        np.testing.assert_array_equal(rows[:n], chips[read])
        assert not rows[n:].any()
        for chip in chips[off]:
            assert not (rows[:n] == chip).all(axis=(1, 2, 3)).any()


# ---- on the card: published widths in bf16 ------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the published towers in bf16 "
                    "run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tower", ["ViT-L-14", "ViT-SO400M-14-SigLIP-384"])
def test_gathered_matches_all_slots_on_the_card(cuda, tower):
    """One 32-frame batch, 20 real 640×480 frames and 12 padding frames
    (repeats of the last, which holds a face), 8 slots a frame: the
    kept-slot embeddings of the gathered path against every slot through
    the tower, 1 − cos ≤ 1e-3."""
    cfg = CV.VIT_L_14 if tower == "ViT-L-14" else SG.SO400M_14_384
    torch.manual_seed(0)
    face = _backend(cfg, device=cuda, dtype=torch.bfloat16, det_size=640,
                    max_faces=8, seed=20261018)
    real = np.full((20, 480, 640, 3), 55, np.uint8)
    for i in range(20):      # one to three faces a frame
        for j in range(i % 3 + 1):
            x = 30 + 190 * j + 5 * i
            draw_face(real[i], FacePlacement(i, j, (x, 120, x + 80, 220)))
    arr, _, valid, _ = pad_batch(list(real), 32)
    want = _all_slots(face, arr)
    with _Spy(face) as spy:
        got = face.extract_batch(arr, valid)
    read = want["mask"] & valid[:, None]
    np.testing.assert_array_equal(got["mask"], read)
    assert want["mask"][~valid].any(), "padding frames hold no face"
    n = int(read.sum())
    assert n >= 20
    assert [b.shape[0] for b in spy.batches] == [embed_bucket(n, 32 * 8)]
    gap = 1 - (got["feats"][read] * want["feats"][read]).sum(-1)
    print(f"{tower} on {torch.cuda.get_device_name(0)}: {n} kept of "
          f"{32 * 8} slots, tower batch {spy.batches[0].shape[0]}, "
          f"1 - cos max {gap.max():.3e} median {np.median(gap):.3e}")
    assert gap.max() <= 1e-3, gap
