"""The sharded SCRFD train step (``parallel/mesh.build_sharded_train_step``)
against the JAX package's on its CPU mesh, and against the port's own
unsharded step.

At the shapes of the JAX package's ``tests/test_sharded_backend.py`` train
case (a slow-tier test, so Tier-1 runs the JAX function only here): SCRFD
TINY at 64 px, ``data:2,model:2``, one fixed batch of 4 scenes (rng 3)
stepped 4 times from JAX's seed-0 init, carried into the port through
``models/bridge``. Checked:

- the first loss, rel ≤ 1e-5, against the JAX loss on those variables
  computed at float64 (``jax.enable_x64``, flax ``dtype=float64``: the JAX
  package's float32 CPU losses and gradients stray further from exact than
  the port's, ``tests/test_torch_train.py``);
- the 4 losses, rel ≤ 2e-3, against JAX's sharded step, and ``npos`` equal;
- the gradients (each leaf within 1e-5 of its largest entry) and the
  BatchNorm running statistics (each within 1e-5 of its largest entry)
  after each of the first two steps, against the port's unsharded step on
  the same global batch (``make_loss_fn``, ``torch.optim.AdamW`` at the
  same settings);
- a per-replica BatchNorm (each replica's own moments) misses that by far;
- a mesh across processes is refused, as JAX's step takes host arrays.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from person_capture_tpu.models import scrfd as JSD  # noqa: E402
from person_capture_tpu.parallel import mesh as JM  # noqa: E402
from person_capture_tpu.train import scrfd_synth as JT  # noqa: E402
from person_capture_tpu_torch.models import bridge  # noqa: E402
from person_capture_tpu_torch.models import scrfd as SD  # noqa: E402
from person_capture_tpu_torch.parallel import mesh as TM  # noqa: E402
from person_capture_tpu_torch.train import scrfd_synth as TT  # noqa: E402
from person_capture_tpu_torch.train.scenes import sample_batch  # noqa: E402

SIZE, BATCH, SEED, STEPS = 64, 4, 0, 4
SPEC = "data:2,model:2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    data = sample_batch(np.random.default_rng(3), BATCH, SIZE)
    targets = TT.build_targets(data["boxes"], data["kps"], data["gt_mask"],
                               SIZE, SD.TINY.strides, SD.TINY.num_anchors)
    return data["images"], targets


@pytest.fixture(scope="module")
def jax_run():
    """JAX's sharded step on ``data:2,model:2``: its initial variables (host
    numpy), the 4 losses and npos, and the first loss at float64."""
    mesh = JM.make_mesh(SPEC, devices=jax.devices("cpu")[:4])
    step, state, _ = JM.build_sharded_train_step(mesh, scrfd_cfg=JSD.TINY,
                                                 size=SIZE, seed=SEED)
    variables = jax.device_get({"params": state["params"],
                                "batch_stats": state["batch_stats"]})
    images, targets = _batch()
    losses, npos = [], []
    for _ in range(STEPS):
        state, metrics = step(state, images, targets)
        losses.append(float(metrics["loss"]))
        npos.append(int(metrics["npos"]))
    with jax.enable_x64(True):
        loss_fn = JT.make_loss_fn(JSD.SCRFD(JSD.TINY, jnp.float64))
        exact, _ = jax.jit(loss_fn)(variables["params"],
                                    variables["batch_stats"], images,
                                    targets)
    return {"variables": variables, "losses": losses, "npos": npos,
            "exact": float(exact)}


def _leaf_err(got, want):
    return float((got - want).abs().max() /
                 want.abs().max().clamp(min=1e-12))


def _port_vs_unsharded(variables, steps=2):
    """The port's sharded step and its unsharded twin from ``variables``:
    per step the losses, npos, and the worst gradient and running-statistic
    error (each relative to its leaf's largest entry)."""
    step, state, model = TM.build_sharded_train_step(
        TM.make_mesh(SPEC, device="cpu"), scrfd_cfg=SD.TINY, size=SIZE,
        seed=SEED)
    bridge.load_scrfd(model, variables)
    twin = copy.deepcopy(model)
    opt = torch.optim.AdamW(twin.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    loss_fn = TT.make_loss_fn(twin)
    images, targets = _batch()
    out = []
    for _ in range(steps):
        state, metrics = step(state, images, targets)
        opt.zero_grad()
        loss, aux = loss_fn(torch.from_numpy(images),
                            [{k: torch.from_numpy(v) for k, v in t.items()}
                             for t in targets])
        loss.backward()
        opt.step()
        grads = max(_leaf_err(p.grad, q.grad) for p, q in
                    zip(model.parameters(), twin.parameters()))
        stats = max(_leaf_err(a, b) for (n, a), b in
                    zip(model.named_buffers(), twin.buffers())
                    if n.endswith(("running_mean", "running_var")))
        out.append({"loss": float(metrics["loss"]),
                    "twin_loss": float(loss.detach()),
                    "npos": int(metrics["npos"]),
                    "twin_npos": int(aux["npos"]),
                    "grads": grads, "stats": stats})
    return state, out


@pytest.fixture(scope="module")
def port_run(jax_run):
    step, state, model = TM.build_sharded_train_step(
        TM.make_mesh(SPEC, device="cpu"), scrfd_cfg=SD.TINY, size=SIZE,
        seed=SEED)
    bridge.load_scrfd(model, jax_run["variables"])
    images, targets = _batch()
    losses, npos = [], []
    for _ in range(STEPS):
        state, metrics = step(state, images, targets)
        losses.append(float(metrics["loss"]))
        npos.append(int(metrics["npos"]))
    return {"losses": losses, "npos": npos, "state": state}


def test_first_loss_matches_jax_at_float64(jax_run, port_run):
    np.testing.assert_allclose(port_run["losses"][0], jax_run["exact"],
                               rtol=1e-5)


def test_losses_match_jax_sharded_step(jax_run, port_run):
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               rtol=2e-3)
    assert port_run["losses"][-1] < port_run["losses"][0]


def test_npos_is_the_global_batch(jax_run, port_run):
    assert port_run["npos"] == jax_run["npos"]


def test_replicas_split_the_wide_layers(port_run):
    """The master keeps plain layers; its optimizer steps the master's
    parameters, the one copy the replicas take before each step."""
    state = port_run["state"]
    model = state["model"]
    assert not any(isinstance(m, TM.ColumnParallel)
                   for m in model.modules())
    params = {id(p) for g in state["opt"].param_groups for p in g["params"]}
    assert params == {id(p) for p in model.parameters()}


def test_gradients_and_statistics_match_unsharded_step(jax_run):
    _, steps = _port_vs_unsharded(jax_run["variables"])
    for s in steps:
        np.testing.assert_allclose(s["loss"], s["twin_loss"], rtol=1e-5)
        assert s["npos"] == s["twin_npos"]
        assert s["grads"] <= 1e-5, s
        assert s["stats"] <= 1e-5, s


def test_per_replica_batchnorm_misses_the_unsharded_step(jax_run,
                                                         monkeypatch):
    """Each replica normalising with its own batch moments (the sum over
    the replicas replaced by the replica's own, scaled to the global
    count): close at the first loss, far in the gradients and statistics."""
    monkeypatch.setattr(TM.RowComm, "all_reduce",
                        lambda self, parts: [p * len(self.devices)
                                             for p in parts])
    _, steps = _port_vs_unsharded(jax_run["variables"], steps=1)
    assert steps[0]["grads"] > 1e-3 and steps[0]["stats"] > 1e-3, steps


def test_multi_process_mesh_is_refused(monkeypatch):
    from person_capture_tpu_torch.parallel import multihost as MH

    monkeypatch.setattr(MH, "is_multiprocess", lambda: True)
    with pytest.raises(ValueError, match="one process"):
        TM.build_sharded_train_step(TM.make_mesh(SPEC, device="cpu"),
                                    scrfd_cfg=SD.TINY, size=SIZE)
