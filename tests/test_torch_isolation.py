"""The torch port stands alone: it imports neither JAX/flax nor anything of
the JAX package, and it never moves to the CPU unasked.

The import check runs in a subprocess because ``tests/conftest.py`` imports
jax into this process.
"""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "person_capture_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "person_capture_tpu")

_CHILD = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import person_capture_tpu_torch as P

names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + ".")]
for name in names:
    importlib.import_module(name)

from person_capture_tpu_torch.kernels import hdr as H
from person_capture_tpu_torch.pipeline.backends import ScrfdArcFaceBackend
from person_capture_tpu_torch.models import arcface as AF, scrfd as SD

be = ScrfdArcFaceBackend(SD.TINY, AF.TINY, det_size=64, max_faces=4,
                         dtype=torch.float32, device="cpu")
frames = np.random.default_rng(0).integers(0, 255, (2, 48, 64, 3), np.uint8)
out = be.extract_batch(frames, np.ones(2, bool))
assert out["feats"].shape == (2, 4, AF.TINY.embed_dim), out["feats"].shape
planes = H.tonemap_planes(torch.rand(3, 8, 8))
assert planes.shape == (3, 8, 8)
from person_capture_tpu_torch.hdr_preview import tonemap_preview_frame
y = np.full((8, 12), 500 << 6, np.uint16)
uv = np.full((4, 6, 2), 512 << 6, np.uint16)
assert tonemap_preview_frame(y, uv, device="cpu").shape == (8, 12, 3)
from person_capture_tpu_torch.pipeline.backends import YoloPersonBackend
from person_capture_tpu_torch.models import yolov8 as YV
pb = YoloPersonBackend(YV.TINY, det_size=64, max_det=4, dtype=torch.float32,
                       device="cpu")
face, person = be.submit_wire_with_person(pb, frames, np.ones(2, bool))()
assert person["boxes"].shape == (2, 4, 4), person["boxes"].shape
from person_capture_tpu_torch.kernels.colormatch import color_match_bgr
from person_capture_tpu_torch.kernels.cleanup import despeckle_bgr
img = torch.from_numpy(frames[0])
assert despeckle_bgr(color_match_bgr(img, img[::2, ::2]))[0].shape == img.shape
import os, tempfile, cv2
from person_capture_tpu_torch.pipeline.backends import ClipReidBackend
from person_capture_tpu_torch.models import clip_vit as CV
from person_capture_tpu_torch.core.bank import RefBank
from person_capture_tpu_torch.core.hashing import phash_bits_batch
from person_capture_tpu_torch import native
from person_capture_tpu_torch.curator import Curator
rb = ClipReidBackend(CV.TINY, batch=4, dtype=torch.float32, device="cpu")
assert rb.extract([frames[0], frames[1][:20]]).shape == (2, 16)
fb = ScrfdArcFaceBackend(YV.TINY_FACE, AF.TINY, det_size=64, max_faces=4,
                         use_arcface=False, clip_face_cfg=CV.TINY,
                         dtype=torch.float32, device="cpu")
assert fb.extract_batch(frames, np.ones(2, bool))["feats"].shape == (2, 4, 16)
gray = torch.from_numpy(frames[:, :32, :32, 0].astype(np.float32))
assert phash_bits_batch(gray).shape == (2, 64)
assert native.phash64_batch(gray.numpy()).shape == (2,)
with tempfile.TemporaryDirectory() as d:
    for i in range(3):
        cv2.imwrite(os.path.join(d, f"f{i:08d}.jpg"), frames[i & 1])
    bank = RefBank(cap=4)
    bank.seed([np.ones(16, np.float32)])
    res = Curator(fb, bank, clip_backend=rb, batch=2, canvas=64).run(
        d, os.path.join(d, "out"), assume_identity=True)
    assert res["metrics"]["pool"] == 3
    # checkpoint loaders, ONNX weights, speckle diagnostics, sweep, doctor
    from person_capture_tpu_torch.models.bridge import flax_variables
    from person_capture_tpu_torch.models import loaders
    from person_capture_tpu_torch.tools import convert_weights, onnx_export
    sd = loaders.torch_state_dict("arcface", flax_variables(
        AF.IResNet(AF.TINY)), AF.TINY)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               os.path.join(d, "arc.pt"))
    assert convert_weights.main(["--src", os.path.join(d, "arc.pt"),
                                 "--kind", "arcface",
                                 "--out", os.path.join(d, "arc.npz")]) == 0
    tpl = flax_variables(AF.IResNet(AF.TINY))
    loaders.load_checkpoint(os.path.join(d, "arc.npz"), "arcface", tpl,
                            AF.TINY)
    for model in ("scrfd_tiny", "arcface_tiny"):
        assert onnx_export.main(["--model", model, "--weights", "random",
                                 "--det-size", "64", "--out",
                                 os.path.join(d, model + ".onnx")]) == 0
    ob = ScrfdArcFaceBackend(det_size=64, max_faces=4, dtype=torch.float32,
                             device="cpu",
                             scrfd_weights=os.path.join(d, "scrfd_tiny.onnx"),
                             arcface_weights=os.path.join(d,
                                                          "arcface_tiny.onnx"))
    assert ob.extract_batch(frames, np.ones(2, bool))["feats"].shape == \
        (2, 4, AF.TINY.embed_dim)
    from person_capture_tpu_torch.hdr.diagnostics import \
        run_speckle_diagnostics
    from person_capture_tpu_torch.hdr.stills import HdrExportParams
    rep = run_speckle_diagnostics(
        np.full((16, 16), 500 << 6, np.uint16),
        np.full((8, 8, 2), 512 << 6, np.uint16), (0, 0, 16, 16),
        os.path.join(d, "diag"), HdrExportParams(device="cpu"))
    assert len(rep["variants"]) == 5
    from person_capture_tpu_torch import doctor, sweep
    from person_capture_tpu_torch.utils.device import classify_error
    assert classify_error("CUDA error: device-side assert") == "backend"
    assert doctor.check_weights()["ok"]
    assert sweep.expand_videos([d]) == []

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
print("MODULES", len(names))
print("FORBIDDEN", bad)
"""


def test_port_imports_nothing_of_jax_in_a_subprocess():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _CHILD % (FORBIDDEN,)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("MODULES", "FORBIDDEN")))
    assert int(lines["MODULES"]) >= 40
    assert lines["FORBIDDEN"] == "[]"


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_name_no_forbidden_import():
    bad = []
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                bad += [(os.path.relpath(path, REPO), m)
                        for m in _imports(path)
                        if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_chip_smoke_imports_nothing_of_jax():
    bad = [m for m in _imports(os.path.join(REPO, "chip_smoke.py"))
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_cuda_device_without_a_card_raises(monkeypatch, tmp_path):
    """The CLI default is ``--device cuda``; with no CUDA device it raises
    at start-up instead of running on the CPU."""
    from person_capture_tpu_torch import main as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--video", str(tmp_path / "v.mp4"), "--ref", str(tmp_path / "r"),
            "--out", str(tmp_path / "out"),
            "--set", "compose_detect_person_for_face=false",
            "--set", "curate_enable=false"]
    ap = M.build_parser()
    args = ap.parse_args(argv)
    assert args.device == "cuda"
    cfg = M.build_config(args, ap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.build_runtime(cfg, args, ap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.main(argv)
