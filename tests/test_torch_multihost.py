"""Multi-process runs of the port (``parallel/multihost.py``) on gloo, on
the CPU.

- The single-process pass-throughs, as the JAX package's helpers.
- A 2-process cluster of the sharded pre-scan step on ``data:4`` and on
  meshes whose model axis spans both processes (``model:2``,
  ``data:1,model:2``, ``model:2,data:2``), and of the spatially sharded
  detect on the latter two: both ranks hold the same gathered result,
  equal (≤ 1e-5, masks equal) to the single-process ``data:4`` step or
  ``data:2,model:2`` step and detect.
- 2-process clusters of the port's CLI (``--multihost --coordinator``)
  with ``--mesh data:2,model:2`` and with ``--mesh model:2,data:2`` (every
  replica across both processes) on the fixture of the JAX package's
  ``tests/test_multihost.py`` (40 frames of 128 px, SCRFD TINY with its
  bundled weights, ArcFace TINY): the primary's and ``.proc1``'s frames are
  identical, equal to the port's single-process mesh run, and equal to the
  JAX CLI's on the same fixture and flags. Both CLIs load one ArcFace
  ``.npz`` (each package's random init draws other numbers).

Each child process has its own timeout; on expiry every child is killed
and the test fails.
"""

from __future__ import annotations

import csv
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from person_capture_tpu_torch.parallel import multihost as MH  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_children(argvs):
    """Start every child at once (one torch thread each), its output going
    to temporary files so that no pipe fills while the parent works."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for argv in argvs:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                       stdout=out, stderr=err), out, err))
    return procs


def _wait_children(procs):
    """Wait for each child within its timeout; return their stdouts. A
    timeout or a non-zero exit fails the test, and every child still
    running is killed."""
    outs = []
    try:
        for p, out, err in procs:
            try:
                p.wait(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"child {p.args[:4]} ran past "
                            f"{CHILD_TIMEOUT_S} s")
            out.seek(0)
            err.seek(0)
            so, se = out.read(), err.read()
            assert p.returncode == 0, \
                f"child failed:\n{so[-3000:]}\n{se[-3000:]}"
            outs.append(so)
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
    return outs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (its children take one
    too): the Tier-1 command runs 6 workers on the machine's cores, and
    these tiny CPU steps gain nothing from more threads but contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_helpers_single_process_passthrough():
    from person_capture_tpu_torch.parallel.mesh import make_mesh

    assert MH.process_count() == 1 and MH.process_index() == 0
    assert MH.is_primary()
    assert not MH.is_multiprocess()
    mesh = make_mesh("data:4", device="cpu")
    arr = np.arange(8, dtype=np.float32)
    assert MH.make_global_batch(mesh, arr) is arr
    rows = {"x": arr}
    assert MH.gather_rows(rows) is rows


def test_multihost_alone_needs_torchrun_or_the_address_flags(monkeypatch):
    for k in MH.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="--coordinator host:port"):
        MH.initialize()
    with pytest.raises(ValueError, match="--num-processes"):
        MH.initialize(coordinator="127.0.0.1:1")
    assert not torch.distributed.is_initialized()


_STEP_CHILD = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from person_capture_tpu_torch.parallel import multihost as MH
rank, port, specs = int(sys.argv[1]), sys.argv[2], sys.argv[3:]
MH.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
              process_id=rank)
assert MH.is_multiprocess() and MH.is_primary() == (rank == 0)
sys.path.insert(0, "tests")
from test_torch_multihost import run_step, run_spatial
from person_capture_tpu_torch.parallel.mesh import make_mesh
out = {}
for spec in specs:
    mesh = make_mesh(spec, device="cpu")
    if spec == "data:4":
        assert mesh.local_replicas() == [2 * rank, 2 * rank + 1]
    else:      # every replica's model axis spans both processes
        assert (mesh.owners.reshape(-1) == [0] * (mesh.size // 2)
                + [1] * (mesh.size // 2)).all()
        assert mesh.local_replicas() == list(range(mesh.num_replicas()))
        out[spec + " spatial"] = run_spatial(mesh)
    out[spec] = run_step(mesh)
out["bf16"] = run_step(make_mesh("data:1,model:2", device="cpu"),
                       torch.bfloat16)
print("MHRESULT " + json.dumps(out))
"""

STEP_KEYS = ("best_fd", "quality", "scores", "mask", "boxes", "feats")


def run_step(mesh, dtype=torch.float32) -> dict:
    """The sharded pre-scan step (SCRFD and ArcFace TINY at their seeded
    init, det 64) on 8 seeded frames, as float32 lists."""
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.parallel.mesh import \
        build_sharded_prescan_step

    run = build_sharded_prescan_step(mesh, scrfd_cfg=SD.TINY,
                                     arcface_cfg=AF.TINY, det_size=64,
                                     max_faces=2, dtype=dtype, seed=0)
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 255, (8, 64, 64, 3)).astype(np.uint8)
    bank = np.zeros((2, AF.TINY.embed_dim), np.float32)
    bank[0, 0] = 1.0
    out = run(frames, bank, np.array([True, False]), score_thresh=0.5)
    return {k: (out[k] if k == "mask" else out[k].float()).tolist()
            for k in STEP_KEYS}


def run_spatial(mesh) -> dict:
    """The spatially sharded detect (SCRFD TINY, bundled weights, det 128)
    on 4 seeded canvases, every slot filled, as lists."""
    from person_capture_tpu_torch.models import scrfd as SD
    from person_capture_tpu_torch.models.zoo import resolve_weights
    from person_capture_tpu_torch.parallel.mesh import \
        build_sharded_fullframe_detect

    run = build_sharded_fullframe_detect(
        mesh, scrfd_cfg=SD.TINY, det_size=128, max_faces=4,
        dtype=torch.float32, scrfd_vars=resolve_weights("auto",
                                                        "scrfd_tiny"))
    canvases = np.random.default_rng(5).uniform(
        0, 255, (4, 128, 128, 3)).astype(np.float32)
    out = run(canvases, np.ones(4, np.float32), score_thresh=0.0)
    return {k: out[k].tolist() for k in ("boxes", "scores", "mask")}


CLUSTER_SPECS = ("data:4", "model:2", "data:1,model:2", "model:2,data:2")


@pytest.fixture(scope="module")
def step_cluster():
    """Both ranks' results of one 2-process cluster over every mesh of
    ``CLUSTER_SPECS``, and the single-process results they are held to:
    the step on ``data:4`` and on ``data:2,model:2``, and the spatial
    detect on ``data:2,model:2``."""
    from person_capture_tpu_torch.parallel.mesh import make_mesh

    port = _free_port()
    procs = _start_children(
        [[sys.executable, "-c", _STEP_CHILD, str(i), str(port),
          *CLUSTER_SPECS] for i in range(2)])
    try:
        single = {"data:4": run_step(make_mesh("data:4", device="cpu"))}
        both = make_mesh("data:2,model:2", device="cpu")
        single["model"] = run_step(both)
        single["spatial"] = run_spatial(both)
        single["bf16"] = run_step(make_mesh("data:1,model:2", device="cpu"),
                                  torch.bfloat16)
    finally:
        outs = _wait_children(procs)
    ranks = [json.loads(next(line for line in so.splitlines()
                             if line.startswith("MHRESULT "))[9:])
             for so in outs]
    return ranks, single


def _assert_same(got: dict, want: dict) -> None:
    assert got["mask"] == want["mask"]
    for k in want:
        if k != "mask":
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


def test_two_process_step_matches_single_process(step_cluster):
    """``data:4`` over two processes: both ranks hold the single-process
    result. A model axis across the processes (``model:2``, refused
    before the port carried it) is accepted and gives the single-process
    result too."""
    ranks, single = step_cluster
    assert ranks[0] == ranks[1]
    _assert_same(ranks[0]["data:4"], single["data:4"])
    _assert_same(ranks[0]["model:2"], single["model"])


@pytest.mark.parametrize("spec", ["data:1,model:2", "model:2,data:2"])
@pytest.mark.parametrize("program", ["step", "spatial"])
def test_model_axis_across_processes_matches_single_process(step_cluster,
                                                            spec, program):
    """Every replica's model axis spans the two processes: the pre-scan
    step (its column slices all-gathered over the row's gloo subgroup)
    and the spatial detect (its slabs' halos and GroupNorm moments over
    it) give, on both ranks, the single-process ``data:2,model:2``
    result."""
    ranks, single = step_cluster
    key = spec if program == "step" else spec + " spatial"
    for rank in ranks:
        _assert_same(rank[key], single["model" if program == "step"
                                        else "spatial"])


def test_model_axis_across_processes_in_bf16(step_cluster):
    """The bf16 step with its model axis across the processes (the slices
    cross gloo as float16 bits, gloo having no bf16): on both ranks, the
    same mesh's bf16 result in one process."""
    ranks, single = step_cluster
    for rank in ranks:
        _assert_same(rank["bf16"], single["bf16"])


# ------------------------------------------------------------- the CLI

SPAN = (8, 28)
MESH = "data:2,model:2"
ACROSS = "model:2,data:2"     # over two processes: every row spans both


def _cli_argv(d, out, mesh=MESH):
    return ["--video", str(d / "m.mp4"), "--ref", str(d / "ref.png"),
            "--out", str(out), "--device", "cpu", "--mesh", mesh,
            "--face-model", "scrfd_tiny", "--arcface-model", "arcface_tiny",
            "--arcface-weights", str(d / "arc.npz"),
            "--det-size", "128", "--batch", "2", "--compute-dtype",
            "float32", "--face-thresh", "0.9", "--face-det-conf", "0.45",
            "--set", "prescan_enable=false", "--set", "min_gap_sec=0.0",
            "--set", "min_box_pixels=400", "--set", "face_quality_min=0.0",
            "--set", "min_sharpness=0.0", "--set", "curate_enable=false",
            "--set", "prescan_cache_mode=off",
            "--set", "compose_crop_enable=false",
            "--set", "compose_detect_person_for_face=false",
            "--set", "smart_crop_enable=false"]


def _hit_frames(out):
    with open(os.path.join(out, "index.csv")) as fh:
        return sorted(int(r["frame"]) for r in csv.DictReader(fh))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    import cv2

    from person_capture_tpu import main as JM
    from person_capture_tpu_torch import main as TM
    from person_capture_tpu_torch.models import arcface as AF
    from person_capture_tpu_torch.models.bridge import flax_variables
    from person_capture_tpu_torch.pipeline.backends import _random_init
    from person_capture_tpu_torch.tools.weights import save_npz_variables
    from person_capture_tpu_torch.video.synthetic import (FacePlacement,
                                                          draw_face,
                                                          generate_video)

    d = tmp_path_factory.mktemp("multihost_cli")
    generate_video(str(d / "m.mp4"), width=128, height=128, fps=30.0,
                   total_frames=40, segments=[(*SPAN, 0)], moving=False)
    ref = np.full((128, 128, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (34, 30, 94, 90)))
    cv2.imwrite(str(d / "ref.png"), ref)
    arc = AF.IResNet(AF.TINY)
    _random_init(arc, 1)
    save_npz_variables(str(d / "arc.npz"), flax_variables(arc))

    clusters = {"cluster": MESH, "across": ACROSS}
    argvs = []
    for name, mesh in clusters.items():
        port = _free_port()
        argvs += [[sys.executable, "-m", "person_capture_tpu_torch.main",
                   *_cli_argv(d, d / name, mesh), "--multihost",
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)]
                  for i in range(2)]
    procs = _start_children(argvs)
    # the single-process runs go while the clusters run
    try:
        assert TM.main(_cli_argv(d, d / "single")) == 0
        assert JM.main(_cli_argv(d, d / "jax")) == 0
    finally:
        outs = _wait_children(procs)
    assert all("Done. Hits:" in so for so in outs), outs
    runs = {"single": _hit_frames(d / "single"),
            "jax": _hit_frames(d / "jax")}
    for name in clusters:
        runs[name] = {"primary": _hit_frames(d / name),
                      "proc1": _hit_frames(d / name / ".proc1")}
    return runs


def test_two_process_cli_ranks_agree(cli_runs):
    primary = cli_runs["cluster"]["primary"]
    assert primary, "the multi-process CLI produced no hits"
    in_span = [f for f in primary if SPAN[0] <= f <= SPAN[1]]
    assert len(in_span) >= max(2, len(primary) // 2)
    assert cli_runs["cluster"]["proc1"] == primary


def test_two_process_cli_matches_single_process_mesh_run(cli_runs):
    assert cli_runs["cluster"]["primary"] == cli_runs["single"]


def test_model_axis_across_processes_cli_matches_jax_cli(cli_runs):
    """``--mesh model:2,data:2`` over two processes puts each replica's
    model axis across both: both ranks write the JAX mesh CLI's frames."""
    across = cli_runs["across"]
    assert across["primary"] == across["proc1"] == cli_runs["jax"]


def test_mesh_cli_matches_jax_cli(cli_runs):
    assert cli_runs["single"] == cli_runs["jax"]


def test_maybe_init_multihost_joins_and_moves_secondaries(monkeypatch,
                                                          tmp_path):
    """The CLI and the sweep join through ``main.maybe_init_multihost``:
    the address flags reach ``initialize``, and a process that is not
    primary writes under ``OUT/.proc{i}``."""
    from person_capture_tpu_torch import main as M

    joined = {}
    monkeypatch.setattr(MH, "initialize", lambda **kw: joined.update(kw))
    monkeypatch.setattr(MH, "process_index", lambda: 1)
    monkeypatch.setattr(MH, "is_primary", lambda: False)
    ap = M.build_parser()
    args = ap.parse_args(["--video", "v", "--ref", "r", "--out", "o",
                          "--multihost", "--coordinator", "h:1",
                          "--num-processes", "2", "--process-id", "1"])
    out = str(tmp_path / "out")
    assert M.maybe_init_multihost(args, out) == os.path.join(out, ".proc1")
    assert joined == {"coordinator": "h:1", "num_processes": 2,
                      "process_id": 1}
    single = ap.parse_args(["--video", "v", "--ref", "r", "--out", "o"])
    assert M.maybe_init_multihost(single, out) == out


def test_sweep_joins_the_cluster(monkeypatch, tmp_path):
    """``sweep --multihost`` without torchrun's environment or the address
    flags stops at the join, naming the flags."""
    from person_capture_tpu_torch import sweep

    for k in MH.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="--coordinator host:port"):
        sweep.main(["--videos", str(tmp_path), "--ref", "r.png", "--out",
                    str(tmp_path / "o"), "--device", "cpu", "--multihost"])
