"""The port's device mesh and sharded pre-scan step (``parallel/mesh.py``,
``core/bank.fd_min_batch``, ``pipeline/backends.ShardedScrfdArcFaceBackend``)
against the JAX package on its 8-device CPU mesh, fp32, with the JAX
variables carried across through ``models/bridge``.

The sharded step runs at the shapes of the JAX package's
``tests/test_sharded_backend.py`` (SCRFD and ArcFace TINY, det 64, 8 frames
of 48×64, ``data:4,model:2``): masks identical, boxes and ``best_fd``
≤ 1e-3 (that test's own tolerance) against JAX's sharded step, and against
the port's unsharded chain on the same weights. On the CPU every mesh entry
is a virtual ``cpu`` device, so the column-parallel split and the row
gather run as they do across cards.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.core.bank import fd_min_batch_jnp  # noqa: E402
from person_capture_tpu.parallel import mesh as JM  # noqa: E402
from person_capture_tpu_torch.core.bank import FD_NONE, fd_min_batch  # noqa: E402
from person_capture_tpu_torch.models import arcface as AF  # noqa: E402
from person_capture_tpu_torch.models import scrfd as SD  # noqa: E402
from person_capture_tpu_torch.parallel import mesh as TM  # noqa: E402
from person_capture_tpu_torch.pipeline import backends as TB  # noqa: E402

SPEC = "data:4,model:2"
DET, FACES, SEED = 64, 4, 3
TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores, and these tiny CPU steps gain
    nothing from more threads but contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", [
    "data:4,model:2", "", "data:8", " data:2 , model:4 ", "x:1,y:2,z:3",
    "bogus", "data:", "data:4,,model:2", "data:-1", "data:2;model:2"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = JM.parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            TM.parse_mesh_spec(spec)
        return
    assert TM.parse_mesh_spec(spec) == want


def test_make_mesh_shapes_and_devices():
    mesh = TM.make_mesh(SPEC, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    assert mesh.replica_devices().shape == (4, 2)
    assert mesh.local_replicas() == [0, 1, 2, 3]
    default = TM.make_mesh("", device="cpu")
    assert default.axis_names == ("data",) and default.size == 1
    four = TM.make_mesh("data:2,model:2", devices=["cpu"] * 4)
    assert four.shape == {"data": 2, "model": 2}
    # another axis replicates: each replica takes its first entry
    other = TM.make_mesh("model:2,data:2,copy:2", device="cpu")
    assert other.replica_devices().shape == (2, 2)


def test_make_mesh_refuses_more_devices_than_there_are(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        TM.make_mesh("data:4")
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        TM.make_mesh("data:3", devices=["cpu"] * 2)


class _Card:
    """``torch.cuda.get_device_properties`` of a card with a UUID."""

    def __init__(self, i):
        self.uuid = f"GPU-{i}"


def _two_processes(monkeypatch, cards: int, ranks_env):
    """The cluster's device list as two processes on one host with
    ``cards`` cards see it: each process's ``local_cards`` under its own
    environment, all-gathered (rank 0 is this process)."""
    from person_capture_tpu_torch.parallel import multihost as MH

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "get_device_properties", _Card)
    keyed = []
    for env in ranks_env:
        for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        keyed.append([(i, TM._card_key(i)) for i in TM.local_cards()])
    monkeypatch.setattr(MH, "process_count", lambda: 2)
    monkeypatch.setattr(torch.distributed, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None), keyed))


TORCHRUN_2 = [{"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2"},
              {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}]


def test_torchrun_ranks_take_their_own_cards(monkeypatch):
    """torchrun --nproc_per_node 2 on a host with two cards: each process
    computes on the card of its LOCAL_RANK, so data:2 puts one replica on
    each card, and data:4 asks for more cards than there are."""
    monkeypatch.delenv(TM.SHARE_CARDS_ENV, raising=False)
    _two_processes(monkeypatch, 2, TORCHRUN_2)
    mesh = TM.make_mesh("data:2")
    assert list(mesh.devices) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    assert mesh.owners.tolist() == [0, 1]
    assert mesh.local_replicas() == [0]
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        TM.make_mesh("data:4")


@pytest.mark.parametrize("cards,ranks_env", [
    (2, [{}, {}]), (1, TORCHRUN_2)], ids=["both_see_both", "one_card"])
def test_processes_sharing_a_card_are_refused_unless_asked(
        monkeypatch, cards, ranks_env):
    """Two processes that would compute on one physical card: refused,
    naming the setting, unless PERSON_CAPTURE_SHARE_CARDS=1 asks for it."""
    monkeypatch.delenv(TM.SHARE_CARDS_ENV, raising=False)
    _two_processes(monkeypatch, cards, ranks_env)
    with pytest.raises(ValueError, match="PERSON_CAPTURE_SHARE_CARDS=1"):
        TM.make_mesh("data:2")
    monkeypatch.setenv(TM.SHARE_CARDS_ENV, "1")
    mesh = TM.make_mesh(f"data:{2 * cards}")
    assert mesh.owners.tolist() == [0] * cards + [1] * cards


def test_model_axis_across_processes_is_refused(monkeypatch):
    """A replica whose model-axis devices belong to two processes (refused
    before the port carried it) is accepted: each rank computes every
    replica in which it holds a device and is handed its rows, the rank of
    a replica's first device leads it, and each rank's ColumnParallel
    holds only its own column slice; the two ranks' slices, in row order,
    are the layer's output. (Two real processes:
    ``tests/test_torch_multihost.py``.)"""
    from person_capture_tpu_torch.parallel import multihost as MH

    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("cpu")] * 4
    mesh = TM.Mesh(devs.reshape(2, 2), ("data", "model"),
                   np.array([[0, 1], [0, 1]]))
    assert mesh.replica_owners().tolist() == [0, 0]
    torch.manual_seed(0)
    layer = torch.nn.Linear(6, 4)
    x = torch.randn(3, 6)
    frames = np.arange(8)
    monkeypatch.setattr(MH, "is_multiprocess", lambda: True)
    slices = []
    for rank in (0, 1):
        monkeypatch.setattr(MH, "process_index", lambda: rank)
        assert mesh.local_replicas() == [0, 1]
        assert MH.make_global_batch(mesh, frames).tolist() == \
            frames.tolist()
        row = TM.RowComm(mesh.replica_devices()[0], [0, 1])
        wrapped = TM.ColumnParallel(layer, row)
        assert row.local == [rank] and len(wrapped.shards) == 1
        with torch.no_grad():
            slices.append(wrapped.shards[0](x))
    np.testing.assert_allclose(torch.cat(slices, -1).numpy(),
                               layer(x).detach().numpy(), atol=1e-6,
                               rtol=0)


def _bank(rng, k, d, live):
    bank = rng.normal(size=(k, d)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    return bank, np.asarray(live, bool)


@pytest.mark.parametrize("case", ["masked_slots", "masked_bank_rows",
                                  "empty_bank", "all_live"])
def test_fd_min_batch_matches_jax(case):
    rng = np.random.default_rng(5)
    feats = (rng.normal(size=(6, 5, 32)) * 3).astype(np.float32)
    feats[0, 0] = 0.0                      # the 1e-6 norm clamp
    feat_mask = rng.random((6, 5)) > 0.3 if case != "all_live" else \
        np.ones((6, 5), bool)
    live = {"masked_slots": [1, 1, 1], "masked_bank_rows": [1, 0, 1],
            "empty_bank": [0, 0, 0], "all_live": [1, 1, 1]}[case]
    bank, bank_mask = _bank(rng, 3, 32, live)
    want = fd_min_batch_jnp(jnp.asarray(feats), jnp.asarray(feat_mask),
                            jnp.asarray(bank), jnp.asarray(bank_mask))
    got = fd_min_batch(torch.from_numpy(feats), torch.from_numpy(feat_mask),
                       torch.from_numpy(bank), torch.from_numpy(bank_mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    if case == "empty_bank":
        assert (got[1].numpy() == FD_NONE).all()


@pytest.mark.parametrize("layer", [
    lambda: torch.nn.Conv2d(6, 8, 3, 2, 1, bias=False),
    lambda: torch.nn.Conv2d(6, 4, 1, 1, 0, bias=True),
    lambda: torch.nn.Conv2d(8, 8, 3, 1, 1, groups=8, bias=False),
    lambda: torch.nn.Conv2d(8, 4, 3, 1, 1, groups=2),
    lambda: torch.nn.Linear(12, 6),
    lambda: torch.nn.Linear(12, 4, bias=False),
], ids=["conv", "conv_bias_1x1", "depthwise", "grouped", "linear",
        "linear_nobias"])
def test_column_parallel_equals_the_layer(layer):
    torch.manual_seed(0)
    bare = layer()
    x = (torch.randn(3, 5, bare.in_features)
         if isinstance(bare, torch.nn.Linear)
         else torch.randn(3, bare.in_channels, 9, 7))
    wrapped = TM.ColumnParallel(bare, TM.RowComm([torch.device("cpu")] * 2))
    assert len(wrapped.shards) == 2
    with torch.no_grad():
        np.testing.assert_allclose(wrapped(x).numpy(), bare(x).numpy(),
                                   atol=1e-6, rtol=0)


def test_shard_params_for_tp_wraps_what_divides():
    mesh = TM.make_mesh("data:1,model:2", device="cpu")
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                              torch.nn.Conv2d(4, 3, 1),
                              torch.nn.Flatten(), torch.nn.Linear(48, 6))
    x = torch.randn(2, 3, 6, 6)
    with torch.no_grad():
        want = net(x)
        TM.shard_params_for_tp(net, mesh)
        got = net(x)
    kinds = [type(m).__name__ for m in net]
    assert kinds == ["ColumnParallel", "ReLU", "Conv2d", "Flatten",
                     "ColumnParallel"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# ------------------------------------------------- the sharded pre-scan step

def _inputs():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (8, 48, 64, 3), dtype=np.uint8)
    bank, bank_mask = _bank(rng, 4, AF.TINY.embed_dim, [1, 1, 1, 1])
    return frames, bank, bank_mask


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded backend on its data:4,model:2 CPU mesh
    (one compile serves the step and the odd-batch cases)."""
    from person_capture_tpu.models import arcface as JAF
    from person_capture_tpu.models import scrfd as JSD
    from person_capture_tpu.pipeline.backends import \
        ShardedScrfdArcFaceBackend

    be = ShardedScrfdArcFaceBackend(
        mesh_spec=SPEC, scrfd_cfg=JSD.TINY, arcface_cfg=JAF.TINY,
        det_size=DET, score_thresh=0.0, max_faces=FACES,
        dtype=jnp.float32, seed=SEED)
    frames, bank, bank_mask = _inputs()
    step = {k: np.asarray(v) for k, v in
            be._run(frames, bank, bank_mask, score_thresh=0.0).items()}
    odd = be.extract_batch(frames[:5], np.ones(5, bool))
    return dict(step=step, odd=odd,
                scrfd_vars=jax.device_get(be._run.scrfd_vars),
                arcface_vars=jax.device_get(be._run.arcface_vars))


@pytest.fixture(scope="module")
def port_sharded(jax_sharded):
    run = TM.build_sharded_prescan_step(
        TM.make_mesh(SPEC, device="cpu"), scrfd_cfg=SD.TINY,
        arcface_cfg=AF.TINY, det_size=DET, max_faces=FACES,
        dtype=torch.float32, scrfd_vars=jax_sharded["scrfd_vars"],
        arcface_vars=jax_sharded["arcface_vars"])
    frames, bank, bank_mask = _inputs()
    out = {k: v.numpy() for k, v in
           run(frames, bank, bank_mask, score_thresh=0.0).items()}
    return run, out


def test_sharded_step_shapes(port_sharded):
    run, out = port_sharded
    assert run.mesh.shape == {"data": 4, "model": 2}
    assert len(run.replicas) == 4
    assert out["boxes"].shape == (8, FACES, 4)
    assert out["kps"].shape == (8, FACES, 5, 2)
    assert out["feats"].shape == (8, FACES, AF.TINY.embed_dim)
    assert out["best_fd"].shape == (8,) and out["mask"].any()
    # every replica's wide layers are split over its two model devices
    wrapped = [m for m in run.replicas[1].scrfd_model.modules()
               if isinstance(m, TM.ColumnParallel)]
    assert wrapped and all(len(m.shards) == 2 for m in wrapped)


def test_sharded_step_matches_jax_sharded_step(jax_sharded, port_sharded):
    want, got = jax_sharded["step"], port_sharded[1]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got["best_fd"], want["best_fd"], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL,
                               rtol=0)


def test_sharded_step_matches_unsharded_chain(port_sharded):
    """The same weights through the port's single-device backend (BGR
    transfer, as the sharded step takes frames) and fd_min_batch."""
    run, got = port_sharded
    frames, bank, bank_mask = _inputs()
    be = TB.ScrfdArcFaceBackend(
        SD.TINY, AF.TINY, det_size=DET, score_thresh=0.0, max_faces=FACES,
        dtype=torch.float32, device="cpu", transfer_format="bgr",
        scrfd_weights=run.scrfd_vars, arcface_weights=run.arcface_vars)
    want = be.extract_batch(frames, np.ones(8, bool))
    _, best = fd_min_batch(torch.from_numpy(want["feats"]),
                           torch.from_numpy(want["mask"]),
                           torch.from_numpy(bank),
                           torch.from_numpy(bank_mask))
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=TOL,
                               rtol=0)
    m = want["mask"]
    np.testing.assert_allclose(got["feats"][m], want["feats"][m], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got["best_fd"], best.numpy(), atol=TOL,
                               rtol=0)


def test_odd_batch_pads_to_the_mesh_as_jax(jax_sharded, port_sharded):
    """Five frames on a 4-replica data axis: the port pads to 8 with the
    last frame, valid=False, and gives JAX's slots."""
    run = port_sharded[0]
    be = TB.ShardedScrfdArcFaceBackend(
        mesh=run.mesh, scrfd_cfg=SD.TINY, arcface_cfg=AF.TINY,
        det_size=DET, score_thresh=0.0, max_faces=FACES,
        dtype=torch.float32, scrfd_weights=run.scrfd_vars,
        arcface_weights=run.arcface_vars)
    frames = _inputs()[0][:5]
    padded, valid, n = be._pad_to_mesh(frames, np.ones(5, bool))
    assert padded.shape[0] == 8 and n == 5
    assert (padded[5:] == frames[-1]).all()
    assert valid.tolist() == [True] * 5 + [False] * 3
    got, want = be.extract_batch(frames, np.ones(5, bool)), jax_sharded["odd"]
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=TOL,
                               rtol=0)
    assert got["feats"].shape == want["feats"].shape == \
        (5, FACES, AF.TINY.embed_dim)


def _unsharded_vs_sharded(scrfd_cfg, scrfd_w, arcface_w, spec="data:2",
                          **settings):
    frames = _inputs()[0]
    sharded = TB.ShardedScrfdArcFaceBackend(
        mesh=TM.make_mesh(spec, device="cpu"), scrfd_cfg=scrfd_cfg,
        arcface_cfg=AF.TINY, det_size=DET, score_thresh=0.0,
        max_faces=FACES, dtype=torch.float32, scrfd_weights=scrfd_w,
        arcface_weights=arcface_w, **settings)
    single = TB.ScrfdArcFaceBackend(
        scrfd_cfg, AF.TINY, det_size=DET, score_thresh=0.0,
        max_faces=FACES, dtype=torch.float32, device="cpu",
        transfer_format="bgr", scrfd_weights=scrfd_w,
        arcface_weights=arcface_w, **settings)
    got = sharded.submit_batch(frames, np.ones(8, bool))()
    want = single.extract_batch(frames, np.ones(8, bool))
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert got["mask"].any()
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=TOL, rtol=0)
    np.testing.assert_allclose(got["kps"], want["kps"], atol=TOL, rtol=0)
    m = want["mask"]
    np.testing.assert_allclose(got["feats"][m], want["feats"][m], atol=TOL,
                               rtol=0)
    return sharded


def test_sharded_yolo_face_branch():
    """The YOLOv8-face detector inside the sharded step (the bundled tiny
    face weights) against the unsharded backend."""
    from person_capture_tpu_torch.models import yolov8 as YV
    from person_capture_tpu_torch.models.zoo import resolve_weights

    _unsharded_vs_sharded(YV.TINY_FACE,
                          resolve_weights("auto", YV.TINY_FACE.name), None,
                          spec="data:2,model:2")


def test_sharded_onnx_branch(tmp_path):
    """ONNX graphs of SCRFD and ArcFace (replicated) inside the sharded
    step against the unsharded backend on the same graphs."""
    from person_capture_tpu_torch.tools import onnx_export

    paths = {}
    for model in ("scrfd_tiny", "arcface_tiny"):
        paths[model] = str(tmp_path / f"{model}.onnx")
        assert onnx_export.main(["--model", model, "--weights", "random",
                                 "--det-size", str(DET),
                                 "--out", paths[model]]) == 0
    be = _unsharded_vs_sharded(SD.TINY, paths["scrfd_tiny"],
                               paths["arcface_tiny"], spec="data:2,model:2")
    assert be.embed_dim == AF.TINY.embed_dim


@pytest.mark.parametrize("settings", [
    {"embed_slots": 2},
    {"use_arcface": False, "clip_face_cfg": "clip_tiny"},
], ids=["embed_slots", "clip_face"])
def test_sharded_step_keeps_the_embedder_settings(settings):
    """``embed_slots`` and a CLIP-face embedder (``use_arcface=False``)
    reach every replica: the same slots and feats as the unsharded
    backend with the same settings."""
    from person_capture_tpu_torch.models import clip_vit as CV

    settings = dict(settings)
    if "clip_face_cfg" in settings:
        settings["clip_face_cfg"] = CV.CONFIGS[settings["clip_face_cfg"]]
    be = _unsharded_vs_sharded(SD.TINY, None, None, spec="data:2,model:2",
                               **settings)
    rep = be._run.replicas[0]
    assert rep.embed_slots == settings.get("embed_slots", 0)
    if "clip_face_cfg" in settings:
        assert rep.arcface_model is None and rep.clip_model is not None
        assert be.embed_dim == settings["clip_face_cfg"].embed_dim
        assert any(isinstance(m, TM.ColumnParallel)
                   for m in rep.clip_model.modules())


def test_check_ported_accepts_the_mesh_and_multihost(tmp_path):
    """The CLI refuses no mesh (its up-front check is gone): the runtime
    built from ``--mesh data:2,model:2 --multihost`` is the sharded
    backend, and it finds the unsharded backend's faces."""
    from person_capture_tpu_torch import main as M

    ap = M.build_parser()
    args = ap.parse_args([
        "--video", "v.mp4", "--ref", "r.png", "--out", str(tmp_path),
        "--device", "cpu", "--mesh", "data:2,model:2", "--multihost",
        "--face-model", "scrfd_tiny", "--arcface-model", "arcface_tiny",
        "--det-size", str(DET), "--compute-dtype", "float32",
        "--face-det-conf", "0.0",
        "--set", "compose_detect_person_for_face=false",
        "--set", "face_fullframe_when_missed=false"])
    cfg = M.build_config(args, ap)
    assert cfg.tpu_mesh == "data:2,model:2"
    sharded = M.build_runtime(cfg, args, ap)["inner_face"]
    assert isinstance(sharded, TB.ShardedScrfdArcFaceBackend)
    assert sharded.mesh.shape == {"data": 2, "model": 2}
    single = TB.ScrfdArcFaceBackend(
        SD.TINY, AF.TINY, det_size=DET, score_thresh=0.0,
        max_faces=cfg.tpu_max_faces, dtype=torch.float32, device="cpu",
        transfer_format="bgr", scrfd_weights=sharded._run.scrfd_vars,
        arcface_weights=sharded._run.arcface_vars)
    frames = _inputs()[0]
    got = sharded.extract_batch(frames, np.ones(8, bool))
    want = single.extract_batch(frames, np.ones(8, bool))
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"].any()
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=TOL,
                               rtol=0)
    m = want["mask"]
    np.testing.assert_allclose(got["feats"][m], want["feats"][m], atol=TOL,
                               rtol=0)
