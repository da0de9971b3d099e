"""The frozen reference against the port's modules at a tiny size on the
CPU, float32: the same faces, embeddings and persons from the same
weights and frames."""

import dataclasses

import numpy as np
import pytest
import torch

from port_bench.reference.pipeline import Reference


def _arch(cfg):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def _port(kind):
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import clip_vit as CV
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models import yolov8 as YV
    from person_capture_tpu_torch.models.bridge import flax_variables
    from person_capture_tpu_torch.pipeline.backends import (
        ScrfdArcFaceBackend, YoloPersonBackend)

    emb_cfg = AF.TINY if kind == "arcface" else CV.TINY
    face = ScrfdArcFaceBackend(
        scrfd_cfg=SD.TINY, arcface_cfg=AF.TINY, det_size=64,
        score_thresh=0.0, max_faces=4, dtype=torch.float32, device="cpu",
        use_arcface=kind == "arcface",
        clip_face_cfg=None if kind == "arcface" else CV.TINY, seed=3)
    person = YoloPersonBackend(cfg=YV.TINY, det_size=64, conf=0.0,
                               max_det=4, dtype=torch.float32, device="cpu",
                               seed=5)
    embedder = face.arcface_model if kind == "arcface" else face.clip_model
    weights = {"detector": flax_variables(face.scrfd_model),
               "embedder": flax_variables(embedder),
               "person": flax_variables(person.model)}
    conf = {"detector": {"det_size": 64, "score_thresh": 0.0,
                         "max_faces": 4, "arch": _arch(SD.TINY)},
            "embedder": {"kind": kind, "arch": _arch(emb_cfg),
                         "bank_dedup_cos": 0.968},
            "person": {"det_size": 64, "conf": 0.0, "max_det": 4,
                       "arch": _arch(YV.TINY)}}
    return face, person, conf, weights


@pytest.mark.parametrize("kind", ["arcface", "clip"])
def test_reference_is_the_port(kind):
    face, person, conf, weights = _port(kind)
    ref = Reference(conf, weights, "cpu")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (3, 48, 64, 3), dtype=np.uint8)
    got_faces, got_persons = face.submit_wire_with_person(
        person, frames, np.ones(3, bool))()
    want = ref.faces(frames)
    assert np.array_equal(got_faces["mask"], want["mask"])
    m = want["mask"]
    np.testing.assert_allclose(got_faces["scores"][m], want["scores"][m],
                               atol=1e-5)
    np.testing.assert_allclose(got_faces["boxes"][m], want["boxes"][m],
                               atol=1e-3)
    np.testing.assert_allclose(got_faces["kps"][m], want["kps"][m],
                               atol=1e-3)
    np.testing.assert_allclose(got_faces["feats"][m], want["feats"][m],
                               atol=1e-4)
    pw = ref.persons(frames)
    assert np.array_equal(got_persons["mask"], pw["mask"])
    pm = pw["mask"]
    np.testing.assert_allclose(got_persons["boxes"][pm], pw["boxes"][pm],
                               atol=1e-3)
    np.testing.assert_allclose(got_persons["scores"][pm], pw["scores"][pm],
                               atol=1e-5)
