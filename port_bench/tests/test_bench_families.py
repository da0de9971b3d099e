"""Model families found by name: the seeded tree, the FLOP counts and the
port's counters read as the harness read them before there were
families, and a family that a configuration names but that cannot serve
it refused."""

import hashlib
import json
import os
from collections import Counter, defaultdict
from types import SimpleNamespace

import numpy as np
import pytest

from port_bench.families import family, family_of
from port_bench.run import Bench, load_weights, one_video, window_context

from .conftest import PKG

SMALL_CLIP = {"name": "small", "image_size": 32, "patch": 8, "width": 32,
              "layers": 2, "heads": 2, "embed_dim": 16}
# sha256 over the leaves (path, then float32 bytes, in path order) of the
# tree that ``clipweights.clip_variables(SMALL_CLIP, 2**31 + 7, "cpu")``
# drew before the clip family existed
SMALL_CLIP_TREE = \
    "e5cc9e6925a15dd381b45a5673aba8922fdbab8b4a676efacbc2e5dd23499b8d"

# what ``flops.py`` counted before the families, per configuration: the
# detector at four canvases, YOLOv8n at its det_size, one chip through
# the embedder
FLOPS = {
    "scrfd_arcface_yolov8n": {
        "detector": {320: 2421222400, 640: 9684889600, 960: 21791001600,
                     1280: 38739558400},
        "person": 8742912000, "embedder": 745414656},
    "scrfd_clipface_vitl14": {
        "detector": {320: 2421222400, 640: 9684889600, 960: 21791001600,
                     1280: 38739558400},
        "person": 8742912000, "embedder": 162025537536},
}


def _conf(name):
    with open(os.path.join(PKG, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def test_seeded_clip_tree_is_the_first_draw():
    from port_bench.clipweights import clip_variables
    from port_bench.reference.weights import flatten_tree

    tree = family("clip").seeded(SMALL_CLIP, 2**31 + 7, "cpu")
    flat = flatten_tree(tree)
    digest = hashlib.sha256()
    for k, v in sorted(flat.items()):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(v, np.float32).tobytes())
    assert digest.hexdigest() == SMALL_CLIP_TREE
    again = flatten_tree(clip_variables(SMALL_CLIP, 2**31 + 7, "cpu"))
    assert all(np.array_equal(flat[k], again[k]) for k in flat)


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_of_the_committed_configurations(name):
    from port_bench.flops import detector_flops, embedder_flops, person_flops

    conf, want = _conf(name), FLOPS[name]
    assert {c: detector_flops(conf["detector"], c)
            for c in want["detector"]} == want["detector"]
    assert person_flops(conf["person"]) == want["person"]
    assert embedder_flops(conf["embedder"]) == want["embedder"]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_every_section_names_its_family(name):
    conf = _conf(name)
    kinds = {role: conf[role]["kind"] for role in
             ("detector", "embedder", "person")}
    assert kinds["detector"] == "scrfd" and kinds["person"] == "yolov8"
    for role, kind in kinds.items():
        assert family_of(conf[role], role) is family(kind)


def test_a_family_without_seeded_weights_refuses_them():
    conf = _conf("scrfd_arcface_yolov8n")
    conf["detector"]["weights"] = "seeded:7"
    with pytest.raises(ValueError, match="draws no seeded weights"):
        load_weights(conf, "cpu")


def test_an_unknown_family_is_named():
    with pytest.raises(KeyError, match="no model family 'nope'"):
        family("nope")


class _Timer:
    def __init__(self, counters):
        self._counters = counters

    def summary(self):
        return {"engine.run": {"total_s": 1.0, "count": 1, "mean_ms": 1e3}}

    def counters(self):
        return dict(self._counters)


def _video(tmp_path, n, timer):
    class Engine:
        _timer = timer

        def run(self):
            return SimpleNamespace(ok=True, error=None)

    M = SimpleNamespace(make_engine=lambda cfg, runtime, status: Engine())
    cfg = SimpleNamespace(video=None, out_dir=None, curate_enable=False)
    probe = SimpleNamespace(attach=lambda eng: None)
    v = one_video(M, cfg, None, probe, "clip.mp4", str(tmp_path / f"v{n}"))
    v["seconds"] = 2.0
    return v


def test_counters_reach_the_readers(tmp_path, manifest):
    """The port's counters of each video, from its timer, summed over the
    videos after the traced one; a run without a timer keeps none."""
    videos = [_video(tmp_path, 0, _Timer({"embed.chips": 999,
                                          "embed.chips_kept": 999})),
              _video(tmp_path, 1, _Timer({"embed.chips": 1024,
                                          "embed.chips_kept": 40,
                                          "prescan.refine_seeks": 1})),
              _video(tmp_path, 2, _Timer({"embed.chips": 2048,
                                          "embed.chips_kept": 17}))]
    probe = SimpleNamespace(curate_s={}, det_frames=defaultdict(Counter),
                            kept=Counter(), person_frames=Counter())
    ctx = window_context(_conf("scrfd_clipface_vitl14"), videos, True, 420,
                         probe, None, "cpu")
    assert ctx["counters"] == {"embed.chips": 3072, "embed.chips_kept": 57,
                               "prescan.refine_seeks": 1}
    read = Bench(manifest).reader("embed.slot_fill_pct")
    assert read(ctx) == pytest.approx(100.0 * 57 / 3072)
    untimed = [_video(tmp_path, 3, None)]
    assert untimed[0]["counters"] == {}
    ctx = window_context(ctx["config"], untimed, False, 420, probe, None,
                         "cpu")
    assert ctx["counters"] == {} and read(ctx) is None
