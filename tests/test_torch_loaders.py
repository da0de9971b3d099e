"""Checkpoint loaders: the port's ``models/loaders.py`` and
``tools/convert_weights.py`` against the JAX package's.

Each checkpoint is written in the official torch names from flax variables
(the bundled ``arcface_synth`` and ``yolov8n_synth``, and a ViT-B-32 tower
at a seeded random draw) by ``loaders.torch_state_dict``, the inverse of the
name maps, then loaded by both packages: equal variables, leaf for leaf,
and equal to the variables it was written from. Then the CLI level: a
converted ArcFace dump (``src/`` keys, written by each package's
``convert_weights.main`` from a ``torch.save`` file) through both CLIs'
``build_runtime`` gives the same embeddings on 4 chips (≤ 1e-5).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu import main as JM  # noqa: E402
from person_capture_tpu.models import loaders as JL  # noqa: E402
from person_capture_tpu.tools import convert_weights as JC  # noqa: E402
from person_capture_tpu_torch import main as TM  # noqa: E402
from person_capture_tpu_torch.models import arcface as TAF  # noqa: E402
from person_capture_tpu_torch.models import bridge as TB  # noqa: E402
from person_capture_tpu_torch.models import clip_vit as TCV  # noqa: E402
from person_capture_tpu_torch.models import loaders as TL  # noqa: E402
from person_capture_tpu_torch.models import yolov8 as TYV  # noqa: E402
from person_capture_tpu_torch.models.zoo import resolve_weights  # noqa: E402
from person_capture_tpu_torch.tools import convert_weights as TC  # noqa: E402
from person_capture_tpu_torch.tools.weights import flatten_tree  # noqa: E402


@functools.lru_cache(maxsize=None)
def _jax_template(kind, name):
    """The JAX package's init variables (read only: the loaders copy)."""
    from person_capture_tpu.models import arcface as AF
    from person_capture_tpu.models import clip_vit as CV
    from person_capture_tpu.models import yolov8 as YV

    key = jax.random.PRNGKey(0)
    if kind == "arcface":
        cfg = AF.CONFIGS[name]
        return cfg, AF.init_arcface(key, cfg)[1]
    if kind == "yolov8":
        cfg = YV.CONFIGS[name]
        return cfg, YV.init_yolo(key, cfg, size=64)[1]
    cfg = CV.CONFIGS[name]
    return cfg, CV.init_clip(key, cfg)[1]


@functools.lru_cache(maxsize=None)
def _port_template(kind, name):
    mod, make = {"arcface": (TAF, TAF.IResNet), "yolov8": (TYV, TYV.YoloV8),
                 "clip": (TCV, TCV.ClipViT)}[kind]
    cfg = mod.CONFIGS[name]
    return cfg, TB.flax_variables(make(cfg))


def _seeded_like(variables, seed):
    """Variables of the same names and shapes, drawn from a seed."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(variables)
    from person_capture_tpu_torch.tools.weights import unflatten_tree

    return unflatten_tree({k: rng.normal(size=v.shape).astype(np.float32)
                           for k, v in flat.items()})


def _assert_same(got, want):
    a, b = flatten_tree(got), flatten_tree(want)
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:8]
    for k in b:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(np.asarray(a[k], np.float32),
                                      np.asarray(b[k], np.float32), err_msg=k)


CHECKPOINTS = [("arcface", "arcface_synth", "arcface_synth"),
               ("yolov8", "yolov8n", "yolov8n"),
               ("clip", "ViT-B-32", None)]


@pytest.mark.parametrize("kind,arch,bundled", CHECKPOINTS,
                         ids=[c[0] for c in CHECKPOINTS])
def test_load_checkpoint_matches_jax(tmp_path, kind, arch, bundled):
    """Written in torch names, stored as an ``.npz`` of raw torch names
    (the ``visual.`` prefix on the CLIP tower), loaded by both packages'
    ``load_checkpoint``."""
    tcfg, ttemplate = _port_template(kind, arch)
    jcfg, jtemplate = _jax_template(kind, arch)
    if bundled:
        variables = resolve_weights("auto", bundled)
    else:   # no bundled ViT-B-32: a seeded draw at the published width
        variables = _seeded_like(ttemplate, seed=3)
    assert tcfg.name == jcfg.name
    sd = TL.torch_state_dict(kind, variables, tcfg)
    if kind == "clip":
        sd = {f"visual.{k}": v for k, v in sd.items()}
    path = str(tmp_path / "raw.npz")
    np.savez(path, **sd)
    got = TL.load_checkpoint(path, kind, ttemplate, tcfg)
    want = JL.load_checkpoint(path, kind, jtemplate, jcfg)
    _assert_same(got, want)
    _assert_same(got, variables)


@pytest.mark.parametrize("kind,arch,bundled", CHECKPOINTS[:2],
                         ids=[c[0] for c in CHECKPOINTS[:2]])
def test_converted_dump_matches_jax(tmp_path, kind, arch, bundled):
    """``torch.save`` → each package's ``convert_weights.main`` (``src/``
    keys, HWIO / [in, out] layouts) → each package's ``load_checkpoint``."""
    tcfg, ttemplate = _port_template(kind, arch)
    jcfg, jtemplate = _jax_template(kind, arch)
    variables = resolve_weights("auto", bundled)
    pt = str(tmp_path / "model.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                TL.torch_state_dict(kind, variables, tcfg).items()}, pt)
    tn, jn = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert TC.main(["--src", pt, "--kind", kind, "--out", tn]) == 0
    assert JC.main(["--src", pt, "--kind", kind, "--out", jn]) == 0
    with np.load(tn) as t, np.load(jn) as j:
        assert sorted(t.files) == sorted(j.files)
        assert all(k.startswith("src/") for k in t.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])
    got = TL.load_checkpoint(tn, kind, ttemplate, tcfg)
    want = JL.load_checkpoint(jn, kind, jtemplate, jcfg)
    _assert_same(got, want)
    _assert_same(got, variables)


def test_loaders_refuse_missing_tensors_alike():
    tcfg, ttemplate = _port_template("arcface", "arcface_synth")
    jcfg, jtemplate = _jax_template("arcface", "arcface_synth")
    sd = TL.torch_state_dict("arcface", resolve_weights("auto",
                                                        "arcface_synth"), tcfg)
    del sd["layer1.0.conv1.weight"]
    with pytest.raises(KeyError) as want:
        JL.load_arcface_torch(jtemplate, jcfg, sd)
    with pytest.raises(KeyError) as got:
        TL.load_arcface_torch(ttemplate, tcfg, sd)
    assert str(got.value) == str(want.value)
    assert "layer1.0.conv1.weight" in str(got.value)


def _argv(tmp_path, extra):
    return ["--video", str(tmp_path / "v.mp4"), "--ref", str(tmp_path / "r"),
            "--out", str(tmp_path / "out"), "--device", "cpu",
            "--compute-dtype", "float32",
            "--set", "compose_detect_person_for_face=false"] + extra


def test_converted_arcface_dump_through_both_clis(tmp_path):
    """Queue C1: a converted torch ArcFace dump given to
    ``--arcface-weights`` loads in both CLIs' ``build_runtime``, and the two
    runtimes embed 4 chips alike (≤ 1e-5)."""
    variables = resolve_weights("auto", "arcface_synth")
    pt = str(tmp_path / "w600k.pt")
    torch.save({k: torch.from_numpy(v) for k, v in TL.torch_state_dict(
        "arcface", variables, TAF.SYNTH_R18).items()}, pt)
    dumps = {}
    for side, conv in (("jax", JC), ("torch", TC)):
        dumps[side] = str(tmp_path / f"{side}_src.npz")
        assert conv.main(["--src", pt, "--kind", "arcface",
                          "--out", dumps[side]]) == 0
    runtimes = {}
    for side, M in (("jax", JM), ("torch", TM)):
        ap = M.build_parser()
        args = ap.parse_args(_argv(tmp_path, [
            "--arcface-model", "arcface_synth",
            "--arcface-weights", dumps[side]]))
        runtimes[side] = M.build_runtime(M.build_config(args, ap), args, ap)
    chips = np.random.default_rng(4).uniform(
        0, 255, (4, 112, 112, 3)).astype(np.float32)
    from person_capture_tpu.models import arcface as JAF

    jb = runtimes["jax"]["inner_face"]
    want = np.asarray(JAF.encode_chips(jb.arcface_model, jb.arcface_vars,
                                       jnp.asarray(chips),
                                       flip_tta=jb.flip_tta))
    got = runtimes["torch"]["inner_face"]._encode(
        torch.from_numpy(chips)).numpy()
    assert got.shape == want.shape == (4, 256)
    assert np.abs(got - want).max() <= 1e-5
