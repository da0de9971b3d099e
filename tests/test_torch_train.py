"""The torch trainers held to the JAX trainers (CPU, tiny widths).

One case per trainer: ``scrfd_tiny`` (64 px), ``yolo_tiny`` and
``yolo_face_tiny`` (64 px), ``arcface_tiny`` (112-px chips), ``clip_tiny``
(32 px), batch 3. The same numpy inputs come from ``step_rng(seed, i)``.

The JAX side runs its own loss (``make_loss_fn``) and train step (its
``make_train_step``, or the step its ``train`` builds inline) under
``optax.adamw`` with the trainers' schedule, jitted, with the flax model
built at ``dtype=float64`` (parameters float32, as always): the JAX
package's own float32 CPU gradients of these losses stray from its float64
ones by up to 1.6 % of a leaf's largest entry (SCRFD), while the port's
float32 gradients agree with the float64 ones to about 1e-5. So the
reference is the JAX function computed exactly, and the port runs float32.
An optax transform around ``adamw`` keeps each step's gradients in its
state, so the step that trains also reports them. Both sides start from
the port's init exported in flax layout.

Checked: the targets and sample streams equal the JAX ones; on the same
bridged variables the loss (rel ≤ 1e-5), every gradient leaf (≤ 1e-4 of
the leaf's largest entry, with a floor of 1e-5 of the model's largest
gradient) and ``batch_stats`` after the step (rtol 1e-5, with an atol of
1e-5 of the leaf's largest entry and a floor of 1e-6 of the largest
statistic, for the means near zero); three AdamW steps (losses rel
≤ 1e-4, parameters within 2·Σ lr_k, the moments by flax path); the
schedule count for count; checkpoint resume and retention; the ``--out``
file against the JAX init's variables, loaded by both packages; the flags.
"""

import contextlib
import functools
import io
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from person_capture_tpu_torch.models import bridge  # noqa: E402
from person_capture_tpu_torch.tools.weights import (  # noqa: E402
    flatten_tree, load_npz_variables)
from person_capture_tpu_torch.train import loop  # noqa: E402
from person_capture_tpu_torch.train.ckpt import (  # noqa: E402
    list_checkpoints, step_rng)

SEED = 3
BATCH = 3
STEPS = 3
NAMES = ("scrfd", "yolo", "yolo_face", "arcface", "clip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the Tier-1 command runs
    6 workers on the machine's cores, and these tiny CPU steps gain
    nothing from more threads but contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the cases

class _Case:
    """One trainer in both packages: its modules, config, how a batch is
    made, the JAX model and step, and the port model from the same
    variables."""

    def __init__(self, name):
        import importlib

        self.name = name
        mod = {"scrfd": "scrfd_synth", "yolo": "yolo_synth",
               "yolo_face": "yolo_face_synth", "arcface": "arcface_synth",
               "clip": "clip_reid_synth"}[name]
        self.J = importlib.import_module(f"person_capture_tpu.train.{mod}")
        self.T = importlib.import_module(
            f"person_capture_tpu_torch.train.{mod}")
        self.cfg_name = {"scrfd": "scrfd_tiny", "yolo": "yolo_tiny",
                         "yolo_face": "yolo_face_tiny",
                         "arcface": "arcface_tiny", "clip": "clip_tiny"}[name]
        self.size = 32 if name == "clip" else 64
        self.lr = 1e-3 if name in ("arcface", "clip") else 2e-3
        self.wd = 5e-5 if name in ("arcface", "clip") else 1e-4
        self.idents = 8
        if name in ("arcface", "clip"):
            rng = np.random.default_rng(SEED)
            self.ident = self.J.make_identities(rng, self.idents)
            self.wclass = (rng.normal(size=(self.idents, self._embed_dim()))
                           * 0.05).astype(np.float32)

    def _embed_dim(self):
        from person_capture_tpu_torch.models import arcface as AF
        from person_capture_tpu_torch.models import clip_vit as CV

        cfgs = AF.CONFIGS if self.name == "arcface" else CV.CONFIGS
        return cfgs[self.cfg_name].embed_dim

    # ---- data -------------------------------------------------------------
    def batch(self, pkg, i):
        """Step ``i``'s inputs from package ``pkg`` (the JAX or the port
        trainer module): ``(images, targets)`` or ``(chips, labels)``."""
        rng = step_rng(SEED, i)
        if self.name == "scrfd":
            d = pkg.sample_batch(rng, BATCH, self.size)
            return d["images"], pkg.build_targets(
                d["boxes"], d["kps"], d["gt_mask"], self.size, (8, 16, 32),
                2)
        if self.name == "yolo":
            d = pkg.sample_person_batch(rng, BATCH, self.size)
            return d["images"], pkg.build_targets(
                d["boxes"], d["gt_mask"], self.size, (8, 16, 32), 16)
        if self.name == "yolo_face":
            d = pkg.sample_batch(rng, BATCH, self.size)
            return d["images"], pkg.build_targets(
                d["boxes"], d["gt_mask"], self.size, (8, 16, 32), 16,
                kps=d["kps"])
        if self.name == "arcface":
            return pkg.sample_chip_batch(rng, self.ident, BATCH)
        return pkg.sample_crop_batch(rng, self.ident, BATCH, self.size)

    # ---- JAX --------------------------------------------------------------
    def jax_input(self, dtype):
        size = 112 if self.name == "arcface" else self.size
        return jnp.zeros((1, size, size, 3), dtype)

    def variables(self):
        """Initial variables in flax layout (numpy float32): the port's
        init for the trainer, exported by ``bridge.flax_variables`` (the
        layout ``test_out_npz_is_the_jax_layout`` holds to the JAX init's).
        They spare the JAX side its op-by-op init (about 20 s for the tiny
        YOLO on the CPU)."""
        from person_capture_tpu_torch.models import arcface as AF
        from person_capture_tpu_torch.models import clip_vit as CV

        if self.name == "arcface":
            model = loop.init_like_flax(
                AF.IResNet(AF.CONFIGS[self.cfg_name]), SEED)
        elif self.name == "clip":
            model = CV.random_init(CV.ClipViT(CV.CONFIGS[self.cfg_name]),
                                   torch.Generator().manual_seed(SEED))
        else:
            model = self.T.init_model(self._port_cfg(), SEED)
        return bridge.flax_variables(model)

    def _port_cfg(self):
        from person_capture_tpu_torch.models import scrfd as SD
        from person_capture_tpu_torch.models import yolov8 as YV

        return (SD if self.name == "scrfd" else YV).CONFIGS[self.cfg_name]

    def jax_module(self, dtype):
        """The JAX package's flax module at ``dtype``."""
        if self.name == "scrfd":
            from person_capture_tpu.models import scrfd as M

            model = M.SCRFD(M.CONFIGS[self.cfg_name], dtype)
        elif self.name in ("yolo", "yolo_face"):
            from person_capture_tpu.models import yolov8 as M

            model = M.YoloV8(M.CONFIGS[self.cfg_name], dtype)
        elif self.name == "arcface":
            from person_capture_tpu.models import arcface as M

            model = M.IResNet(M.CONFIGS[self.cfg_name], dtype)
        else:
            from person_capture_tpu.models import clip_vit as M

            model = M.ClipViT(M.CONFIGS[self.cfg_name], dtype)
        return model

    def jax_run(self):
        """STEPS jitted JAX steps at float64 from :meth:`variables`: per step
        the loss, the gradients (flat flax paths) and the state after."""
        model = self.jax_module(jnp.float64)
        variables = self.variables()
        sched = optax.warmup_cosine_decay_schedule(
            0.0, self.lr, warmup_steps=min(100, STEPS // 10 + 1),
            decay_steps=STEPS, end_value=self.lr * 0.02)
        adamw = optax.adamw(sched, weight_decay=self.wd)

        def update(g, s, p=None):
            updates, inner = adamw.update(g, s[0], p)
            return updates, (inner, g)

        # adamw whose state also keeps the step's gradients
        tx = optax.GradientTransformation(
            lambda p: (adamw.init(p),
                       jax.tree_util.tree_map(jnp.zeros_like, p)), update)
        if self.name in ("arcface", "clip"):
            trainable = {"params": variables["params"],
                         "wclass": jnp.asarray(self.wclass)}
            state = {"params": variables["params"],
                     "wclass": jnp.asarray(self.wclass),
                     "opt_state": tx.init(trainable)}
            if "batch_stats" in variables:
                state["batch_stats"] = variables["batch_stats"]
            step = self.J.make_train_step(model, tx, self.idents)
        else:
            state = {"params": variables["params"],
                     "batch_stats": variables["batch_stats"],
                     "opt_state": tx.init(variables["params"])}
            if self.name == "scrfd":
                step = self.J.make_train_step(model, tx)
            else:
                step = _jax_yolo_step(self.J.make_loss_fn(model), tx)
        out = []
        for i in range(STEPS):
            state, metrics = step(state, *self.batch(self.J, i))
            grads = state["opt_state"][1]
            if self.name not in ("arcface", "clip"):
                grads = {"params": grads}
            adam = state["opt_state"][0][0]      # ScaleByAdamState
            moments = {m: getattr(adam, m) for m in ("mu", "nu")}
            if self.name not in ("arcface", "clip"):
                moments = {m: {"params": v} for m, v in moments.items()}
            out.append({"loss": float(metrics["loss"]),
                        "grads": _flat(grads),
                        "moments": {m: _flat(v) for m, v in moments.items()},
                        "state": _flat({k: v for k, v in state.items()
                                        if k != "opt_state"})})
        return variables, out

    # ---- port -------------------------------------------------------------
    def torch_state(self, variables):
        """The port's model with ``variables`` and its TrainState, loss
        function and the extra tensors the loss takes first."""
        from person_capture_tpu_torch.models import arcface as AF
        from person_capture_tpu_torch.models import clip_vit as CV
        from person_capture_tpu_torch.models import scrfd as SD
        from person_capture_tpu_torch.models import yolov8 as YV

        host = jax.device_get(variables)
        if self.name == "scrfd":
            model = bridge.load_scrfd(SD.SCRFD(SD.CONFIGS[self.cfg_name]),
                                      host)
        elif self.name in ("yolo", "yolo_face"):
            model = bridge.load_yolov8(
                YV.YoloV8(YV.CONFIGS[self.cfg_name]), host)
        elif self.name == "arcface":
            model = bridge.load_arcface(
                AF.IResNet(AF.CONFIGS[self.cfg_name]), host)
        else:
            model = bridge.load_clip(CV.ClipViT(CV.CONFIGS[self.cfg_name]),
                                     host)
        extra = ({"wclass": self.wclass}
                 if self.name in ("arcface", "clip") else None)
        ts = loop.TrainState(model, self.lr, STEPS, self.wd,
                             torch.device("cpu"), extra=extra)
        if extra:
            loss_fn = self.T.make_loss_fn(model, self.idents)
        else:
            loss_fn = self.T.make_loss_fn(model)
        return ts, loss_fn

    def torch_step(self, ts, loss_fn, i):
        a, b = self.batch(self.T, i)
        args = [loop.to_device(a, ts.device), loop.to_device(b, ts.device)]
        if ts.extra:
            args.insert(0, ts.extra["wclass"])
        return ts.step(loss_fn, *args)

    def torch_grads(self, ts, of=lambda p, st: p.grad):
        """Each parameter's gradient (or ``of(param, optimizer state)``)
        by flax path."""
        g = bridge.flax_params(ts.model, {n: of(p, ts.opt.state[p]) for n, p
                                          in ts.model.named_parameters()})
        if ts.extra:
            w = ts.extra["wclass"]
            g["wclass"] = of(w, ts.opt.state[w]).numpy().copy()
        return flatten_tree(g)

    def torch_vars(self, ts):
        v = bridge.flax_variables(ts.model)
        if ts.extra:
            v["wclass"] = ts.extra["wclass"].detach().numpy().copy()
        return flatten_tree(v)


def _jax_yolo_step(loss_fn, tx):
    """The step ``yolo_synth.train`` / ``yolo_face_synth.train`` build
    inline, over their ``make_loss_fn``."""

    @jax.jit
    def step_fn(state, images_u8, targets):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state["params"], state["batch_stats"], images_u8, targets)
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["params"])
        params = optax.apply_updates(state["params"], updates)
        return ({"params": params, "batch_stats": aux["batch_stats"],
                 "opt_state": opt_state}, {"loss": loss})

    return step_fn


def _flat(tree):
    return {k: np.asarray(v, np.float64)
            for k, v in flatten_tree(jax.device_get(tree)).items()}


@functools.lru_cache(maxsize=None)
def _run(name):
    """Both packages' STEPS steps for one trainer, computed once."""
    case = _Case(name)
    with jax.enable_x64(True):
        variables, ref = case.jax_run()
    ts, loss_fn = case.torch_state(variables)
    got = []
    for i in range(STEPS):
        m = case.torch_step(ts, loss_fn, i)
        got.append({"loss": float(m["loss"]), "grads": case.torch_grads(ts),
                    "moments": {
                        "mu": case.torch_grads(
                            ts, lambda p, st: st["exp_avg"]),
                        "nu": case.torch_grads(
                            ts, lambda p, st: st["exp_avg_sq"])},
                    "state": case.torch_vars(ts),
                    "lr": loop.warmup_cosine(i, case.lr, STEPS)})
    return case, variables, ref, got


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("name", NAMES)
def test_batches_equal_jax(name):
    """Copied code: the targets and sample streams equal the JAX ones."""
    case = _Case(name)
    for i in range(2):
        a, b = case.batch(case.J, i), case.batch(case.T, i)
        np.testing.assert_array_equal(a[0], b[0])
        if isinstance(a[1], list):
            assert len(a[1]) == len(b[1]) == 3
            for la, lb in zip(a[1], b[1]):
                assert la.keys() == lb.keys()
                for k in la:
                    np.testing.assert_array_equal(la[k], lb[k])
                    assert la[k].dtype == lb[k].dtype
        else:
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("name", NAMES)
def test_first_step_loss_grads_and_stats(name):
    case, _variables, ref, got = _run(name)
    r, g = ref[0], got[0]
    assert abs(g["loss"] - r["loss"]) <= 1e-5 * abs(r["loss"])
    assert g["grads"].keys() == r["grads"].keys()
    # a leaf whose exact gradient is zero (the bias of a BatchNorm that
    # feeds another through a linear layer) carries only float32 rounding:
    # each leaf's tolerance has a floor of 1e-5 of the model's largest
    floor = 1e-5 * max(np.abs(v).max() for v in r["grads"].values())
    for k, want in r["grads"].items():
        np.testing.assert_allclose(g["grads"][k], want,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   rtol=0, err_msg=k)
    stats = [k for k in r["state"] if k.startswith("batch_stats/")]
    assert (len(stats) > 0) == (name != "clip")
    # the same floor for a mean that is zero in exact arithmetic (a
    # BatchNorm over a sum of BatchNorm outputs)
    floor = 1e-6 * max([np.abs(r["state"][k]).max() for k in stats] or [0])
    for k in stats:
        want = r["state"][k]
        np.testing.assert_allclose(g["state"][k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max() + floor,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_three_adamw_steps(name):
    case, _variables, ref, got = _run(name)
    losses = [g["loss"] for g in got]
    np.testing.assert_allclose(losses, [r["loss"] for r in ref], rtol=1e-4)
    tol = 2 * sum(g["lr"] for g in got)
    assert tol > 0
    params = [k for k in ref[-1]["state"] if not k.startswith("batch_")]
    assert set(params) == {k for k in got[-1]["state"]
                           if not k.startswith("batch_")}
    for k in params:
        np.testing.assert_allclose(got[-1]["state"][k], ref[-1]["state"][k],
                                   atol=tol, rtol=0, err_msg=k)
    # AdamW's moments by flax path (bridge.flax_params): the running means
    # of the gradients and of their squares, which the parameters' small
    # drift moves a little further than the first step's gradients
    for m, floor in (("mu", 1e-4), ("nu", 1e-8)):
        want, have = ref[-1]["moments"][m], got[-1]["moments"][m]
        assert have.keys() == want.keys()
        top = max(np.abs(v).max() for v in want.values())
        for k, v in want.items():
            np.testing.assert_allclose(
                have[k], v, rtol=0,
                atol=1e-3 * np.abs(v).max() + floor * top, err_msg=k)


@pytest.mark.parametrize("lr,steps", [(2e-3, 1500), (1e-3, 1200),
                                      (1e-3, 3), (5e-4, 40)])
def test_schedule_matches_optax(lr, steps):
    """The LambdaLR gives optax's lr per count, 0 at the first update."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps,
        end_value=lr * 0.02)
    model = torch.nn.Linear(2, 2)
    ts = loop.TrainState(model, lr, steps, 0.0, torch.device("cpu"))
    counts = sorted(set(range(0, steps + 5, max(1, steps // 97)))
                    | {0, 1, steps - 1, steps, steps + 3})
    seen = {}
    with warnings.catch_warnings():
        # no optimizer step here: only the schedule is read
        warnings.simplefilter("ignore", UserWarning)
        for c in range(max(counts) + 1):
            seen[c] = ts.opt.param_groups[0]["lr"]
            ts.sched.step()
    for c in counts:
        assert abs(seen[c] - float(sched(c))) <= 1e-7, (c, seen[c])
    assert seen[0] == 0.0


def _small_train(case, monkeypatch, steps, **kw):
    # the held-out evaluation reads the state and changes nothing
    monkeypatch.setattr(case.T, "evaluate", lambda *a, **k: {})
    args = dict(cfg_name=case.cfg_name, steps=steps, lr=case.lr, seed=1,
                log_every=1000, eval_every=0, device="cpu", **kw)
    if case.name in ("arcface", "clip"):
        args.update(batch=BATCH, num_ident=case.idents)
    else:
        args.update(size=case.size, batch=BATCH)
    with contextlib.redirect_stdout(io.StringIO()):
        return case.T.train(**args)


@pytest.mark.parametrize("name", NAMES)
def test_resume_matches_uninterrupted_run(name, tmp_path, monkeypatch):
    """The fast counterpart of tests/test_train_ckpt.py: a run resumed at
    step 2 ends where the uninterrupted 4-step run ends."""
    case = _Case(name)
    straight, _ = _small_train(case, monkeypatch, 4)
    ck = str(tmp_path / "ck")
    _small_train(case, monkeypatch, 2, ckpt_dir=ck, ckpt_every=1)
    assert [s for s, _ in list_checkpoints(ck)] == [1, 2]
    resumed, _ = _small_train(case, monkeypatch, 4, ckpt_dir=ck,
                              ckpt_every=1)
    a, b = flatten_tree(straight), flatten_tree(resumed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-6, err_msg=k)


def test_checkpoint_retention_keeps_latest_two(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    _small_train(_Case("scrfd"), monkeypatch, 5, ckpt_dir=ck, ckpt_every=1)
    assert [s for s, _ in list_checkpoints(ck)] == [4, 5]


def test_step_rng_is_the_jax_one():
    from person_capture_tpu.train.ckpt import step_rng as jax_step_rng

    for seed, step in ((0, 0), (3, 10), (7, 1499)):
        np.testing.assert_array_equal(
            step_rng(seed, step).integers(0, 1 << 30, 8),
            jax_step_rng(seed, step).integers(0, 1 << 30, 8))


@pytest.mark.parametrize("name", NAMES)
def test_out_npz_is_the_jax_layout(name, tmp_path):
    """``--out`` from a 2-step ``main`` on the CPU: the flax key set,
    shapes and float16 of the JAX init's variables; it loads strictly into
    the port's model and the JAX model's ``apply`` takes it."""
    case = _Case(name)
    out = str(tmp_path / "w.npz")
    argv = ["--cfg", case.cfg_name, "--batch", str(BATCH), "--steps", "2",
            "--device", "cpu", "--out", out]
    argv += (["--idents", "8"] if name in ("arcface", "clip")
             else ["--size", str(case.size)])
    with contextlib.redirect_stdout(io.StringIO()):
        assert case.T.main(argv) == 0
    model = case.jax_module(jnp.float32)
    x = case.jax_input(jnp.float32)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(SEED), x)
    want = {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    data = np.load(out)
    assert set(data.files) == set(want)
    for k in want:
        assert data[k].shape == want[k].shape, k
        assert data[k].dtype == np.float16, k
    loaded = {k: np.asarray(v, np.float32) for k, v in
              flatten_tree(load_npz_variables(out)).items()}
    from person_capture_tpu_torch.tools.weights import unflatten_tree

    tree = unflatten_tree(loaded)
    ts, _ = case.torch_state(tree)
    assert flatten_tree(bridge.flax_variables(ts.model)).keys() == \
        loaded.keys()
    # the JAX model's apply takes it (traced for shapes: a missing leaf or
    # a shape the module does not take raises)
    assert jax.tree_util.tree_leaves(jax.eval_shape(model.apply, tree, x))


def _flags(main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return {w.split("=")[0].strip("[],") for w in buf.getvalue().split()
            if w.startswith(("--", "[--"))}


@pytest.mark.parametrize("name", NAMES)
def test_main_flags_are_the_jax_ones(name, monkeypatch):
    """The JAX trainer's flags, ``--device`` in place of ``--platform``;
    the default device is the card, and without one ``main`` raises."""
    case = _Case(name)
    assert _flags(case.T.main) == (_flags(case.J.main) - {"--platform"}) \
        | {"--device"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        case.T.main(["--cfg", case.cfg_name, "--steps", "2"])


def test_batchnorm_keeps_flax_running_statistics():
    """Flax's running statistics after a training step: momentum 0.99
    (torch 0.01) and the biased batch variance, on ArcFace's final
    BatchNorm1d at n = 4, where torch's own update writes var·4/3."""
    import flax.linen as fnn

    from person_capture_tpu_torch.models.layers import BatchNorm1d

    x = np.random.default_rng(0).normal(1.0, 2.0, (4, 6)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    y_j, mut = bn.apply(v, x, mutable=["batch_stats"])
    tb = BatchNorm1d(6, eps=1e-5, momentum=0.01).train()
    y_t = tb(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, atol=1e-5)
    np.testing.assert_allclose(tb.running_mean.numpy(),
                               mut["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(tb.running_var.numpy(),
                               mut["batch_stats"]["var"], rtol=1e-6)
