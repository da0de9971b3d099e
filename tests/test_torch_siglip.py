"""The SigLIP face tower of the torch port (``models/siglip.py``) against
the benchmark's plain float32 reference (``port_bench/reference/
siglip.py``), and the CLIP-face path built on it.

Seeded, on the CPU, at the tiny sibling's widths (``siglip_tiny``: width
32, 2 layers, 2 heads, MLP 72, 32 px). The weights are the benchmark's
seeded tree in big_vision's layout, loaded into the port by
``bridge.load_siglip`` and into the reference by its own loader; the
chips are 112-px BGR face-sized arrays as the aligner makes them.

Tolerances:
- fp32 port against the fp32 reference: rows' 1 − cos ≤ 1e-6 and max
  abs ≤ 1e-5 on L2-normalised rows. The two compute the same float32
  operations in another order and form (one fused qkv GEMM against
  three, ``scaled_dot_product_attention`` against an explicit softmax,
  torch's tanh GELU against the written formula), each rounding at about
  6e-8 of values of order 1 through two blocks; measured about 1.3e-7.
- bf16 port against the fp32 reference: 1 − cos ≤ 5e-4. bf16 keeps 8
  bits, a relative rounding of 2^-9 per stored value, and the rows'
  1 − cos is about half the squared relative error, some 1e-5 to 1e-4
  after the tower; measured about 3e-5.
Each planted fault (erf GELU, mean pooling in place of the MAP head,
CLIP's normalisation in place of 0.5/0.5) breaks the fp32 comparison.
"""

import csv
import dataclasses
import os

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from port_bench.families import family  # noqa: E402
from person_capture_tpu_torch.models import clip_vit as CV  # noqa: E402
from person_capture_tpu_torch.models import siglip as S  # noqa: E402
from person_capture_tpu_torch.models.bridge import load_siglip  # noqa: E402
from person_capture_tpu_torch.utils.timing import (  # noqa: E402
    NULL_TIMER, StepTimer)

FP32_COS, FP32_ABS, BF16_COS = 1e-6, 1e-5, 5e-4
ARCH = dataclasses.asdict(S.TINY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores, and these tiny CPU runs gain
    nothing from more threads but contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers():
    fam = family("siglip")
    tree = fam.seeded(ARCH, 2**31 + 11, "cpu")
    ref = fam.reference(ARCH)
    fam.load_reference(ref, tree)
    port = load_siglip(S.SiglipViT(S.TINY), tree)
    return fam, tree, ref.eval(), port.eval()


def _chips(n=6, seed=0):
    """Face-sized BGR chips: smooth noise over a bright disc."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (n, 112, 112, 3)).astype(np.float32)
    x = np.stack([cv2.GaussianBlur(c, (9, 9), 3) for c in x])
    yy, xx = np.mgrid[:112, :112]
    disc = ((yy - 56) ** 2 + (xx - 56) ** 2 < 35 ** 2)[None, :, :, None]
    return torch.from_numpy(np.where(disc, 0.5 * x + 110, x))


def _gaps(a, b):
    return float((1 - (a * b).sum(-1)).max()), float((a - b).abs().max())


def test_port_matches_the_reference_in_fp32(towers):
    fam, _, ref, port = towers
    chips = _chips()
    want = fam.encode(ref, chips)
    got = CV.encode_images(port, chips)
    assert got.shape == want.shape == (6, 32)
    cos, mx = _gaps(got, want)
    assert cos <= FP32_COS and mx <= FP32_ABS, (cos, mx)
    # rows of different chips are far apart: the comparison can see a fault
    assert float((1 - want @ want.T).max()) > 100 * FP32_ABS


def test_port_in_bf16_against_the_fp32_reference(towers):
    fam, tree, ref, _ = towers
    port = load_siglip(S.SiglipViT(S.TINY), tree).eval().to(torch.bfloat16)
    chips = _chips(seed=1)
    cos, _ = _gaps(CV.encode_images(port, chips), fam.encode(ref, chips))
    assert cos <= BF16_COS, cos


def _erf_gelu(monkeypatch):
    monkeypatch.setattr(S, "gelu_tanh", torch.nn.functional.gelu)


def _mean_pool(monkeypatch):
    monkeypatch.setattr(S.MapHead, "forward",
                        lambda self, x, timer=NULL_TIMER: x.mean(1))


def _clip_norm(monkeypatch):
    from person_capture_tpu_torch.ops.preprocess import normalize_clip

    monkeypatch.setattr(S.SiglipViT, "normalize",
                        staticmethod(normalize_clip))


@pytest.mark.parametrize("plant", [_erf_gelu, _mean_pool, _clip_norm],
                         ids=["erf_gelu", "mean_pool", "clip_norm"])
def test_planted_faults_fail_the_comparison(towers, monkeypatch, plant):
    fam, _, ref, port = towers
    chips = _chips(seed=2)
    want = fam.encode(ref, chips)
    plant(monkeypatch)
    cos, mx = _gaps(CV.encode_images(port, chips), want)
    assert cos > FP32_COS or mx > FP32_ABS, (cos, mx)


def test_load_siglip_is_strict(towers):
    from person_capture_tpu_torch.tools.weights import (flatten_tree,
                                                        unflatten_tree)

    _, tree, _, _ = towers
    flat = flatten_tree(tree)
    short = dict(flat)
    short.pop("params/MAPHead_0/probe")
    with pytest.raises(KeyError, match="probe"):
        load_siglip(S.SiglipViT(S.TINY), unflatten_tree(short))
    extra = dict(flat, **{"params/cls": np.zeros((1, 1, 32), np.float32)})
    with pytest.raises(KeyError, match="not used"):
        load_siglip(S.SiglipViT(S.TINY), unflatten_tree(extra))


def test_random_init_is_seeded():
    a = S.random_init(S.SiglipViT(S.TINY), torch.Generator().manual_seed(5))
    b = S.random_init(S.SiglipViT(S.TINY), torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.blocks[0].ln1.weight, torch.ones(32))
    assert not a.head.kv.bias.any() and a.head.probe.std() > 0


def test_published_widths():
    cfg = S.CONFIGS["ViT-SO400M-14-SigLIP-384"]
    assert (cfg.image_size, cfg.patch, cfg.width, cfg.layers, cfg.heads,
            cfg.mlp_dim, cfg.embed_dim) == (384, 14, 1152, 27, 16, 4304,
                                            1152)
    assert cfg.width // cfg.heads == 72
    with torch.device("meta"):
        n = sum(p.numel() for p in S.SiglipViT(cfg).parameters())
    assert 427e6 < n < 429e6          # So400m's tower: 428 M parameters
    with pytest.raises(ValueError, match="MAP head"):
        S.SiglipViT(dataclasses.replace(S.TINY, pool="mean"))


@pytest.mark.parametrize("cfg", [S.TINY, CV.TINY], ids=["siglip", "clip"])
def test_attention_spans_nest_inside_the_tower_span(cfg, tmp_path):
    """``face.attn`` opens once per attention call (each block, and the
    MAP head), inside ``face.encode``, through the backend's timer."""
    from port_bench.trace import read
    from torch.profiler import ProfilerActivity, profile

    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.pipeline.backends import \
        ScrfdArcFaceBackend

    face = ScrfdArcFaceBackend(SD.TINY, AF.TINY, det_size=64, max_faces=2,
                               score_thresh=-1.0, use_arcface=False,
                               clip_face_cfg=cfg, dtype=torch.float32,
                               device="cpu")
    timer = StepTimer()
    face.timer = timer
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            face.extract_batch(np.zeros((2, 48, 64, 3), np.uint8),
                               np.ones(2, bool))
    finally:
        face.timer = NULL_TIMER
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = read(path).ranges
    outer = [(a, b) for n, a, b, _ in ranges if n == "face.encode"]
    inner = [(a, b) for n, a, b, _ in ranges if n == "face.attn"]
    calls = cfg.layers + isinstance(cfg, S.SiglipConfig)
    assert len(outer) == 1 and len(inner) == calls
    assert all(outer[0][0] <= a and b <= outer[0][1] for a, b in inner)
    assert timer.counts["face.attn"] == calls


def test_encode_images_takes_a_tower_without_projection(towers):
    """``encode_images`` reads the dtype from the parameters (a SigLIP
    tower has no ``proj``) and the normalisation from the tower."""
    _, tree, _, _ = towers
    port = load_siglip(S.SiglipViT(S.TINY), tree).eval()
    assert not hasattr(port, "proj")
    chips = _chips(n=2)
    got = CV.encode_images(port, chips)
    with torch.inference_mode():
        x = CV.resize_bicubic(chips, 32, 32)
        want = port((x.flip(-1) / 127.5 - 1.0).contiguous())
    want = want / want.norm(dim=-1, keepdim=True)
    assert torch.allclose(got, want, atol=1e-6)


# ---- the CLI --------------------------------------------------------------

def _fixture(d):
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face,
                                                          generate_video)

    sv = generate_video(str(d / "vid.mp4"), width=160, height=120, fps=30,
                        total_frames=40, segments=[(5, 18, 0), (24, 34, 0)],
                        moving=True, seed=1)
    ref = np.full((200, 200, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (40, 40, 160, 160)))
    cv2.imwrite(str(d / "ref.png"), ref)
    return sv


def _parse(d, *sets, extra=()):
    from person_capture_tpu_torch import main as M

    argv = ["--video", str(d / "vid.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(d / "out"), "--batch", "4", "--det-size", "160",
            "--prescan", "--device", "cpu", "--compute-dtype", "float32",
            "--face-det-conf", "0.3", "--face-thresh", "0.9",
            *extra]
    for s in ("prescan_cache_mode=off", "curate_enable=false") + sets:
        argv += ["--set", s]
    ap = M.build_parser()
    args = ap.parse_args(argv)
    return M, ap, args, M.build_config(args, ap)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("siglip_cli")
    sv = _fixture(d)
    M, ap, args, cfg = _parse(d, "use_arcface=false",
                              "clip_face_backbone=siglip_tiny",
                              "face_fullframe_imgsz=320")
    runtime = M.build_runtime(cfg, args, ap)
    res = M.make_engine(cfg, runtime, status=lambda *a, **k: None).run()
    return d, sv, runtime, res


def test_cli_builds_the_siglip_tower(cli_run):
    _, _, runtime, _ = cli_run
    face, rescue = runtime["inner_face"], runtime["fullframe"]._get()
    for be in (face, rescue):
        assert isinstance(be.clip_model, S.SiglipViT)
        assert be.clip_model.cfg is S.TINY and be.arcface_model is None
        assert be.embed_dim == 32
    assert rescue.det_size == 320


def test_cli_run_finds_the_target(cli_run):
    d, sv, _, res = cli_run
    assert res.ok, res.error
    with open(d / "out" / "index.csv", newline="") as fh:
        frames = [int(r["frame"]) for r in csv.DictReader(fh)]
    truth = {f for s, e in sv.identity_spans(0) for f in range(s, e + 1)}
    assert frames and set(frames) <= truth
    assert os.path.isdir(d / "out" / "crops")


@pytest.mark.parametrize("sets,extra,field", [
    (("use_arcface=false", "clip_face_backbone=ViT-nope"), (),
     "clip_face_backbone"),
    (("reid_backbone=ViT-nope",), ("--match-mode", "either"),
     "reid_backbone"),
])
def test_unknown_backbone_is_a_config_error(tmp_path, capsys, sets, extra,
                                            field):
    M, ap, args, cfg = _parse(tmp_path, *sets, extra=extra)
    with pytest.raises(SystemExit):
        M.build_runtime(cfg, args, ap)
    err = capsys.readouterr().err
    assert f"{field}='ViT-nope'" in err and "ViT-L-14" in err
    if field == "clip_face_backbone":
        assert "ViT-SO400M-14-SigLIP-384" in err and "siglip_tiny" in err


def test_resolve_reid_refuses_an_unknown_backbone():
    from person_capture_tpu_torch.main import resolve_reid

    with pytest.raises(ValueError, match="reid_backbone='ViT-nope'"):
        resolve_reid("ViT-nope", "random")
    cfg, weights = resolve_reid("ViT-B-32", "random")
    assert cfg is CV.VIT_B_32 and weights is None
