"""A model family is added by new files only: a copy of the harness takes
a toy embedder family and a configuration that names it, with no file of
the copy edited. The copy runs in its own process, as the package."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from .conftest import PKG, ROOT

TOY_FAMILY = '''"""A toy face embedder: two dense layers over a pooled chip."""

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.families import config_args


@dataclasses.dataclass(frozen=True)
class ToyConfig:
    name: str = "toy"
    pool: int = 4
    width: int = 32
    embed_dim: int = 32


class Toy(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.fc0 = nn.Linear(3 * cfg.pool ** 2, cfg.width)
        self.fc1 = nn.Linear(cfg.width, cfg.embed_dim)

    def forward(self, x):
        x = F.adaptive_avg_pool2d(x, self.cfg.pool).flatten(1)
        return self.fc1(F.gelu(self.fc0(x)))


def _shapes(cfg):
    return {"fc0": (3 * cfg.pool ** 2, cfg.width),
            "fc1": (cfg.width, cfg.embed_dim)}


def reference(arch):
    return Toy(ToyConfig(**config_args(arch)))


def load_reference(model, tree):
    with torch.no_grad():
        for name, leaves in tree["params"].items():
            layer = getattr(model, name)
            layer.weight.copy_(torch.from_numpy(leaves["kernel"]).T)
            layer.bias.copy_(torch.from_numpy(leaves["bias"]))


def seeded(arch, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = {}
    for name, (fan_in, fan_out) in _shapes(ToyConfig(**config_args(arch))).items():
        kernel = torch.randn(fan_in, fan_out, generator=gen, device=device)
        params[name] = {"kernel": (kernel * fan_in ** -0.5).cpu().numpy(),
                        "bias": np.zeros(fan_out, np.float32)}
    return {"params": params}


def port_model(runtime):
    return runtime["inner_face"].toy_model


def load_port(backends, tree):
    for face in backends:
        face.toy_model.tree = tree


def flops(arch, size=None):
    return sum(2 * a * b for a, b in _shapes(ToyConfig(**config_args(arch))).values())


def encode(model, chips):
    x = chips.float().permute(0, 3, 1, 2) / 255.0
    with torch.no_grad():
        e = model(x)
    return e / e.norm(dim=-1, keepdim=True).clamp(min=1e-10)


def dim(model):
    return int(model.cfg.embed_dim)
'''

DRIVE = '''
import dataclasses, json, sys, types
import numpy as np
import torch

import port_bench
from port_bench import traffic
from port_bench.families import config_args, family
from port_bench.flops import embedder_flops, layer_flops
from port_bench.reference import scrfd as SD, yolov8 as YV
from port_bench.reference.pipeline import Reference
from port_bench.run import _agree, load_weights

assert port_bench.__file__.startswith(sys.argv[1]), port_bench.__file__
with open("port_bench/configs/toy_embedder.json") as fh:
    conf = json.load(fh)
weights = load_weights(conf, "cpu")
frames = np.full((3, 240, 320, 3), 50, np.uint8)
for n, img in enumerate(frames):
    traffic.draw_person(img, n % 2, (60 + 80 * n, 40, 100 + 80 * n, 80))
ref = Reference(conf, weights, "cpu")
faces = ref.faces(frames)
toy = family("toytower")
arch = conf["embedder"]["arch"]
model = toy.reference(arch)
ns = types.SimpleNamespace
face = ns(scrfd_model=ns(cfg=SD.SCRFDConfig(**config_args(
              conf["detector"]["arch"]))),
          toy_model=ns(cfg=toy.ToyConfig(**config_args(arch))),
          det_size=conf["detector"]["det_size"],
          score_thresh=conf["detector"]["score_thresh"],
          max_faces=conf["detector"]["max_faces"], embed_slots=0,
          transfer_format=conf["detector"]["wire"], dtype=torch.bfloat16)
person = ns(model=ns(cfg=YV.YoloConfig(**config_args(conf["person"]["arch"]))),
            det_size=conf["person"]["det_size"], conf=conf["person"]["conf"],
            max_det=conf["person"]["max_det"])
cfg = ns(prescan_diversity_dedup_cos=conf["embedder"]["bank_dedup_cos"],
         tpu_mainpass_analysis_max_w=conf["detector"]["analysis_width"])
runtime = {"inner_face": face, "person": person}
_agree(conf, cfg, runtime)
toy.load_port([face], weights["embedder"])
loaded = face.toy_model.tree is weights["embedder"]
face.toy_model = ns(cfg=dataclasses.replace(face.toy_model.cfg, width=64))
try:
    _agree(conf, cfg, runtime)
    refused = False
except ValueError as e:
    refused = "embedder arch" in str(e)
kept = faces["mask"]
print(json.dumps({
    "kept": int(kept.sum()), "dim": int(faces["feats"].shape[-1]),
    "norms": [float(x) for x in np.linalg.norm(faces["feats"][kept], axis=-1)],
    "flops": embedder_flops(conf["embedder"]),
    "counted": layer_flops(model, torch.empty(1, 3, 112, 112)),
    "loaded": loaded,
    "mismatch_refused": refused}))
'''


def _files(base):
    out = {}
    for d, dirs, fs in os.walk(base):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_family_is_added_by_new_files(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "port_bench"
    shutil.copytree(PKG, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    # the bundled weights, read as data, beside the copy as in a checkout
    (root / "person_capture_tpu").mkdir()
    os.symlink(os.path.join(ROOT, "person_capture_tpu", "weights"),
               root / "person_capture_tpu" / "weights")
    before = _files(bench)

    (bench / "families" / "toytower.py").write_text(TOY_FAMILY)
    with open(bench / "configs" / "scrfd_arcface_yolov8n.json") as fh:
        conf = json.load(fh)
    conf.update(name="toy_embedder")
    conf["embedder"] = {"kind": "toytower", "weights": "seeded:2147483659",
                        "arch": {"name": "toy", "pool": 4, "width": 32,
                                 "embed_dim": 32},
                        "bank_dedup_cos": 0.968}
    (bench / "configs" / "toy_embedder.json").write_text(json.dumps(conf))

    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", DRIVE, str(root)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["kept"] >= 1 and got["dim"] == 32
    assert all(abs(n - 1.0) < 1e-5 for n in got["norms"]), got["norms"]
    assert got["flops"] == got["counted"] == 2 * (48 * 32 + 32 * 32)
    assert got["loaded"] and got["mismatch_refused"]

    after = _files(bench)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"families/toytower.py",
                                        "configs/toy_embedder.json"}
