"""The SigLIP configuration and its family: the FLOPs at the published
widths against a count by hand, the run held to the file's widths
(``_agree``) on a tiny arch, the two readers it adds, and the control
failing its limits on the card."""

import dataclasses
import json
import os
import types

import pytest

from port_bench.families import config_args, family
from port_bench.run import Bench, _agree

from .conftest import PKG

NAME = "scrfd_siglipface_so400m14_384"


def _conf():
    with open(os.path.join(PKG, "configs", f"{NAME}.json")) as fh:
        return json.load(fh)


def test_flops_at_published_widths_by_hand():
    arch = _conf()["embedder"]["arch"]
    assert (arch["image_size"], arch["patch"], arch["width"], arch["layers"],
            arch["heads"], arch["mlp_dim"], arch["embed_dim"],
            arch["pool"]) == (384, 14, 1152, 27, 16, 4304, 1152, "map")
    tokens, w, mlp = 27 * 27, 1152, 4304
    patch = 2 * tokens * w * (14 * 14 * 3)
    qkv, out = 2 * tokens * w * (3 * w), 2 * tokens * w * w
    scores = values = 2 * 16 * tokens * tokens * (w // 16)
    fc = 2 * 2 * tokens * w * mlp
    head = (2 * w * w + 2 * tokens * w * (2 * w) + 2 * 16 * 2 * tokens
            * (w // 16) + 2 * w * w + 2 * 2 * w * mlp)
    want = patch + 27 * (qkv + scores + values + out + fc) + head
    assert want == 670_346_449_920            # about 670 GFLOP a chip
    from port_bench.flops import embedder_flops

    assert family("siglip").flops(arch) == embedder_flops(
        _conf()["embedder"]) == want


def _runtime(conf, tower_cfg):
    from port_bench.reference import scrfd as SD
    from port_bench.reference import yolov8 as YV
    import torch

    ns = types.SimpleNamespace
    det, per = conf["detector"], conf["person"]
    face = ns(scrfd_model=ns(cfg=SD.SCRFDConfig(**config_args(det["arch"]))),
              clip_model=ns(cfg=tower_cfg), det_size=det["det_size"],
              score_thresh=det["score_thresh"], max_faces=det["max_faces"],
              embed_slots=0, transfer_format=det["wire"],
              dtype=torch.bfloat16)
    person = ns(model=ns(cfg=YV.YoloConfig(**config_args(per["arch"]))),
                det_size=per["det_size"], conf=per["conf"],
                max_det=per["max_det"])
    cfg = ns(prescan_diversity_dedup_cos=conf["embedder"]["bank_dedup_cos"],
             tpu_mainpass_analysis_max_w=det["analysis_width"])
    return cfg, {"inner_face": face, "person": person}


def test_the_run_holds_the_port_to_the_files_widths():
    from person_capture_tpu_torch.models import siglip as S

    conf = _conf()
    tiny = dataclasses.asdict(S.TINY)
    conf["embedder"]["arch"] = tiny
    cfg, runtime = _runtime(conf, S.TINY)
    _agree(conf, cfg, runtime)
    # the port's published tower is the file's
    conf_full = _conf()
    cfg, runtime = _runtime(conf_full, S.SO400M_14_384)
    _agree(conf_full, cfg, runtime)
    for change in ({"mlp_dim": 128}, {"heads": 4}, {"pool": "mean"}):
        cfg, runtime = _runtime(conf, dataclasses.replace(S.TINY, **change))
        with pytest.raises(ValueError, match="embedder arch"):
            _agree(conf, cfg, runtime)


def test_config_limits_cover_every_number():
    from port_bench.check import GAPS
    from port_bench.run import EXACT

    conf = _conf()
    limits = conf["check"]["limits"]
    layer = {f"{g}_gap{m}" for g in GAPS for m in ("", "_med")}
    assert set(EXACT) <= set(limits) <= set(EXACT) | layer
    assert all(limits[k] == 0 for k in EXACT)
    assert {k.split("_gap")[0].split("_")[0] for k in limits
            if k not in EXACT} >= {"face", "embed", "person"}
    assert conf["embedder"]["kind"] == "siglip"
    assert "clip_face_backbone=ViT-SO400M-14-SigLIP-384" in conf["sets"]


def test_the_cell_is_declared(manifest):
    bench = Bench(manifest)
    cell = bench.cell("siglip.sdr1080_dense")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        NAME, "sdr1080_dense", 1)
    entry = next(c for c in manifest["configs"] if c["name"] == NAME)
    assert entry["reduced"] == [] and entry["source"] == _conf()["source"]
    reported = {m["name"] for m in manifest["per_layer"]
                if bench.reports(m, cell)}
    assert {"siglip_roofline", "embed.attn_device_s_per_video",
            "model.mfu", "device.idle_pct"} <= reported
    assert "embed_roofline" not in reported


def _ctx(trace, kept, conf=None):
    return {"config": conf or _conf(), "trace": trace, "kept": kept,
            "device_name": "NVIDIA H100 80GB HBM3"}


def _trace():
    """Thread 1: face.encode [0, 100] holding face.attn [10, 20] and
    [30, 40]; kernels launched in each attention range, in the tower
    outside them, and outside the tower (µs)."""
    from port_bench.trace import Trace

    tr = Trace(window_s=1.0, busy_s=0.5)
    tr.ranges += [("face.encode", 0.0, 100.0, 1), ("face.attn", 10.0, 20.0, 1),
                  ("face.attn", 30.0, 40.0, 1)]
    tr.launches.update({1: (15.0, 1), 2: (35.0, 1), 3: (50.0, 1),
                        4: (150.0, 1), 5: (15.0, 2)})
    tr.device += [("flash", 200.0, 1200.0, 1), ("flash", 1300.0, 2300.0, 2),
                  ("gemm", 2400.0, 6400.0, 3), ("nms", 7000.0, 9000.0, 4),
                  ("other thread", 9000.0, 9500.0, 5)]
    return tr


def test_siglip_roofline_reads_the_tower_range(manifest):
    from port_bench.flops import embedder_flops
    from port_bench.peaks import peak_flops

    ctx = _ctx(_trace(), {0: 64})
    want = 100.0 * 64 * embedder_flops(_conf()["embedder"]) \
        / (6e-3 * peak_flops(ctx["device_name"], "bfloat16"))
    read = Bench(manifest).reader("siglip_roofline")
    assert read(ctx) == pytest.approx(want)
    with open(os.path.join(PKG, "configs", "scrfd_clipface_vitl14.json")) as fh:
        assert read(_ctx(_trace(), {0: 64}, json.load(fh))) is None


@pytest.mark.parametrize("case", ["no_range", "no_kernel"])
def test_siglip_roofline_stops_a_run_it_cannot_read(manifest, case):
    from port_bench.trace import Trace

    tr = Trace(window_s=1.0, busy_s=0.5)
    if case == "no_kernel":
        tr.ranges.append(("face.encode", 0.0, 10.0, 1))
    with pytest.raises(RuntimeError):
        Bench(manifest).reader("siglip_roofline")(_ctx(tr, {0: 64}))


def test_attention_seconds_read_the_attention_ranges(manifest):
    from port_bench.trace import Trace

    read = Bench(manifest).reader("embed.attn_device_s_per_video")
    assert read(_ctx(_trace(), {})) == pytest.approx(2e-3)
    # a port without the span: nothing to read, nothing raised
    bare = _trace()
    bare.ranges = [r for r in bare.ranges if r[0] != "face.attn"]
    assert read(_ctx(bare, {})) is None
    assert read(_ctx(None, {})) is None
    assert read(_ctx(Trace(), {})) is None


@pytest.mark.cuda
def test_control_fails_siglip(tmp_path, cuda):
    from port_bench.check import compare_layers
    from port_bench.reference.pipeline import Reference
    from port_bench.run import load_weights

    from .test_bench_control import _frames, _photo

    conf = _conf()
    with open(os.path.join(PKG, "traffic", "sdr1080_dense.json")) as fh:
        mix = json.load(fh)
    frames = _frames(tmp_path, mix, 2**31 + 3, 16)
    weights = load_weights(conf, cuda)
    ref = Reference(conf, weights, cuda)
    low = Reference(conf, weights, cuda, precision="fp8")
    photo = _photo(tmp_path)
    got = compare_layers(low.faces(frames), low.persons(frames),
                         low.bank(photo), ref.faces(frames),
                         ref.persons(frames), ref.bank(photo),
                         conf["detector"]["score_thresh"],
                         conf["person"]["conf"])
    limits = conf["check"]["limits"]
    assert any(got[k] > limits[k] for k in got if k in limits), got
