"""The port's Qt GUI shell (``gui_app.py``), run headless under the fake
Qt double (``tests/fake_qt.py``): the JAX package's GUI cases on the port's
window, a run of each package's window through ``on_start`` on one
fixture (the same ``index.csv`` frames), and the default backend's device:
built on the CPU when the device field says so, and a failed run, never a
quiet move to the CPU, when it says ``cuda`` and there is no card.
"""

from __future__ import annotations

import csv
import os
import sys
import threading
from dataclasses import fields

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fake_qt  # noqa: E402
from person_capture_tpu_torch.config import LIVE_KEYS, SessionConfig  # noqa: E402
from person_capture_tpu_torch.pipeline.backends import (  # noqa: E402
    LazyBackend, OracleBackend)
from person_capture_tpu_torch.video.synthetic import (  # noqa: E402
    FacePlacement, draw_face, generate_video)

GUI = "person_capture_tpu_torch.gui_app"
JAX_GUI = "person_capture_tpu.gui_app"
JOIN_S = 180


def _qt(monkeypatch):
    """Fake PySide6 with an empty QSettings store of this test's own, so no
    test sees another's saved window state (the store is class-level)."""
    fake_qt.install(monkeypatch)
    monkeypatch.setattr(fake_qt.QSettings, "_stores", {})


@pytest.fixture()
def gui(monkeypatch):
    _qt(monkeypatch)
    monkeypatch.delitem(sys.modules, GUI, raising=False)
    import person_capture_tpu_torch.gui_app as gui_app

    yield gui_app
    sys.modules.pop(GUI, None)


@pytest.fixture()
def synth(tmp_path):
    import cv2

    vid = str(tmp_path / "g.mp4")
    sv = generate_video(vid, width=160, height=120, fps=30.0,
                        total_frames=90, segments=[(0, 80, 0)])
    ref = np.full((120, 120, 3), 60, np.uint8)
    draw_face(ref, FacePlacement(0, 0, (20, 20, 100, 100)))
    ref_path = str(tmp_path / "ref.png")
    cv2.imwrite(ref_path, ref)
    return sv, ref_path


def _join(bridge):
    bridge._thread.join(timeout=JOIN_S)
    assert not bridge._thread.is_alive(), "engine thread still running"


def _start_oracle_run(win, sv, ref_path, out):
    """The JAX package's window test settings, then the real Start path."""
    win.video_edit.setText(sv.path)
    win.ref_list.addItem(ref_path)
    win.out_edit.setText(out)
    win.min_gap.setValue(0.3)
    win.frame_stride.setValue(3)
    win.prescan_enable.setChecked(False)
    win.curate_enable.setChecked(False)
    for name, value in (("tpu_batch_frames", 8), ("min_box_pixels", 50),
                        ("face_quality_min", 0), ("min_sharpness", 0)):
        win._field_widgets[name][0].setValue(value)
    win.start_btn.click()
    assert win.bridge is not None
    _join(win.bridge)


def _frames(out):
    with open(os.path.join(out, "index.csv")) as fh:
        return [int(r["frame"]) for r in csv.DictReader(fh)]


def test_gui_import_gated(monkeypatch):
    """Without PySide6 the module raises an ImportError naming PySide6 and
    the port's CLI; with it, the import succeeds."""
    monkeypatch.delitem(sys.modules, GUI, raising=False)
    try:
        import PySide6  # noqa: F401
        has_qt = True
    except ImportError:
        has_qt = False
    if has_qt:
        import person_capture_tpu_torch.gui_app  # noqa: F401
    else:
        with pytest.raises(ImportError,
                           match=r"PySide6.*person_capture_tpu_torch\.main"):
            import person_capture_tpu_torch.gui_app  # noqa: F401
    sys.modules.pop(GUI, None)


def test_window_constructs_and_binds_every_config_field(gui):
    win = gui.MainWindow(backend_factory=lambda: None)
    names = {f.name for f in fields(SessionConfig)}
    bound = set(win._field_widgets)
    assert bound <= names
    assert len(bound) >= 0.8 * len(names), \
        f"settings tab binds only {len(bound)}/{len(names)} fields"
    win.video_edit.setText("v.mp4")
    win.ref_list.addItem("r.png")
    win.out_edit.setText("outdir")
    win.face_thresh.setValue(0.37)
    win.frame_stride.setValue(4)
    cfg = win._collect_cfg()
    assert cfg.video == "v.mp4" and cfg.ref == "r.png"
    assert cfg.out_dir == "outdir"
    assert abs(cfg.face_thresh - 0.37) < 1e-9
    assert cfg.frame_stride == 4
    assert cfg.device == "cuda"


def test_engine_run_through_window_start(gui, synth, tmp_path):
    sv, ref_path = synth
    win = gui.MainWindow(backend_factory=lambda: OracleBackend(sv))
    out = str(tmp_path / "out")
    _start_oracle_run(win, sv, ref_path, out)
    log = "\n".join(win.log_pane.lines)
    assert "done" in log, log
    assert "hit f" in log, log
    assert win.progress_bar.value() > 0
    assert win.preview_label._pixmap is not None     # previews rendered
    assert os.path.isfile(os.path.join(out, "index.csv"))


def test_gui_run_matches_jax_window(monkeypatch, synth, tmp_path):
    """Both packages' windows, each with its own package's oracle backend,
    driven through on_start with the same settings on one fixture: the
    same index.csv frames."""
    from person_capture_tpu.pipeline.backends import \
        OracleBackend as JaxOracle

    _qt(monkeypatch)
    sv, ref_path = synth
    frames = {}
    for name, module, oracle in ((JAX_GUI, JAX_GUI, JaxOracle),
                                 (GUI, GUI, OracleBackend)):
        monkeypatch.delitem(sys.modules, module, raising=False)
        mod = __import__(module, fromlist=["MainWindow"])
        win = mod.MainWindow(backend_factory=lambda o=oracle: o(sv))
        out = str(tmp_path / name.split(".")[0])
        _start_oracle_run(win, sv, ref_path, out)
        assert "done" in win.log_pane.lines, win.log_pane.lines
        frames[name] = _frames(out)
        sys.modules.pop(module, None)
    assert frames[GUI], "the port's window found no hits"
    assert frames[GUI] == frames[JAX_GUI]


def test_settings_keys_are_the_jax_windows(gui, monkeypatch):
    """One QSettings store for both packages' windows: a user's saved
    video, references and output folder carry over."""
    monkeypatch.delitem(sys.modules, JAX_GUI, raising=False)
    import person_capture_tpu.gui_app as jax_gui

    assert (gui.ORG, gui.APP) == (jax_gui.ORG, jax_gui.APP)
    jax_win = jax_gui.MainWindow(backend_factory=lambda: None)
    jax_win.video_edit.setText("saved.mp4")
    jax_win.ref_list.addItem("a.png")
    jax_win.close()
    win = gui.MainWindow(backend_factory=lambda: None)
    assert win.video_edit.text() == "saved.mp4"
    assert win.ref_list.item(0).text() == "a.png"
    sys.modules.pop(JAX_GUI, None)


def test_live_key_push_reaches_engine(gui):
    win = gui.MainWindow(backend_factory=lambda: None)
    pushed = {}

    class FakeBridge:
        def update_cfg(self, **kv):
            pushed.update(kv)

    win.bridge = FakeBridge()
    assert "face_thresh" in LIVE_KEYS
    w, _default, _kind = win._field_widgets["face_thresh"]
    w.setValue(0.21)                            # valueChanged → _push_live
    assert pushed == {"face_thresh": 0.21}
    assert win.cfg.face_thresh == 0.21


def test_preset_save_load_roundtrip(gui, tmp_path, monkeypatch):
    win = gui.MainWindow(backend_factory=lambda: None)
    win.face_thresh.setValue(0.33)
    win.frame_stride.setValue(7)
    preset = str(tmp_path / "p.json")
    monkeypatch.setattr(fake_qt.QFileDialog, "getSaveFileName",
                        staticmethod(lambda *a, **k: (preset, "")))
    win._save_preset()
    assert os.path.isfile(preset)
    win2 = gui.MainWindow(backend_factory=lambda: None)
    monkeypatch.setattr(fake_qt.QFileDialog, "getOpenFileName",
                        staticmethod(lambda *a, **k: (preset, "")))
    win2._load_preset()
    assert abs(win2.face_thresh.value() - 0.33) < 1e-9
    assert win2.frame_stride.value() == 7


def test_qsettings_persist_and_restore(gui):
    win = gui.MainWindow(backend_factory=lambda: None)
    win.video_edit.setText("persisted.mp4")
    win.out_edit.setText("persist_out")
    win.ref_list.addItem("a.png")
    win.ref_list.addItem("b.png")
    win.close()                                  # closeEvent persists
    win2 = gui.MainWindow(backend_factory=lambda: None)
    assert win2.video_edit.text() == "persisted.mp4"
    assert win2.out_edit.text() == "persist_out"
    assert [win2.ref_list.item(i).text()
            for i in range(win2.ref_list.count())] == ["a.png", "b.png"]


def test_preset_load_refreshes_generated_widgets(gui, tmp_path, monkeypatch):
    """Loading a preset refreshes the generated settings tab, so the
    loaded values survive config collection at Start."""
    import json

    preset = str(tmp_path / "p.json")
    with open(preset, "w") as fh:
        json.dump({"prescan_stride": 48, "min_det_conf": 0.77,
                   "save_annot": True, "face_thresh": 0.19,
                   "device": "cpu"}, fh)
    win = gui.MainWindow(backend_factory=lambda: None)
    monkeypatch.setattr(fake_qt.QFileDialog, "getOpenFileName",
                        staticmethod(lambda *a, **k: (preset, "")))
    win._load_preset()
    w, _d, _k = win._field_widgets["prescan_stride"]
    assert w.value() == 48
    cfg = win._collect_cfg()
    assert cfg.prescan_stride == 48
    assert abs(cfg.min_det_conf - 0.77) < 1e-9
    assert cfg.save_annot is True
    assert abs(cfg.face_thresh - 0.19) < 1e-9
    assert cfg.device == "cpu"


def test_bridge_commands_before_engine_ready(gui):
    """pause/stop/seek clicked while the backend is still building reach
    the Engine: the bridge constructs it eagerly."""
    cfg = SessionConfig()
    cfg.video = "nonexistent.mp4"
    cfg.ref = "nonexistent.png"
    bridge = gui.EngineBridge(cfg, lambda: None)
    done = []
    bridge.finished.connect(lambda ok, err: done.append((ok, err)))
    bridge.start()
    assert bridge._engine is not None
    bridge.stop()
    bridge.seek(10)
    _join(bridge)
    assert done and done[0][0] is False


def test_aux_factories_follow_config(gui):
    """The Start path builds person/ReID/full-frame factories exactly when
    the run's config needs them (main.py's conditional construction)."""
    win = gui.MainWindow(backend_factory=lambda: None)
    cfg = SessionConfig(match_mode="face_only", skip_yolo_when_faceonly=True,
                        face_fullframe_when_missed=False)
    assert set(win._aux_factories(cfg)) == {"person"}
    cfg.compose_detect_person_for_face = False
    assert win._aux_factories(cfg) == {}
    cfg = SessionConfig(match_mode="either",
                        face_fullframe_when_missed=False)
    assert set(win._aux_factories(cfg)) == {"person", "reid"}
    assert cfg.disable_reid is False
    cfg = SessionConfig(match_mode="face_only", skip_yolo_when_faceonly=True,
                        compose_detect_person_for_face=False,
                        face_fullframe_when_missed=True,
                        face_fullframe_imgsz=1408)
    assert set(win._aux_factories(cfg)) == {"fullframe"}
    cfg.face_fullframe_imgsz = 640          # no upscale ⇒ no rescue tower
    assert win._aux_factories(cfg) == {}


def test_bridge_wires_aux_backends_lazily(gui):
    """Aux factories reach the Engine as LazyBackends without being built
    at Start."""
    cfg = SessionConfig(video="nonexistent.mp4", ref="nonexistent.png")
    built = []
    bridge = gui.EngineBridge(
        cfg, lambda: None,
        aux_factories={"person": lambda: built.append("person"),
                       "reid": lambda: built.append("reid")})
    done = []
    bridge.finished.connect(lambda ok, err: done.append(ok))
    bridge.start()
    eng = bridge._engine
    assert isinstance(eng.person_backend, LazyBackend)
    assert isinstance(eng.reid_backend, LazyBackend)
    assert eng.fullframe_backend is None
    _join(bridge)
    assert built == []
    assert done == [False]


def test_generated_tab_edit_survives_collect(gui):
    win = gui.MainWindow(backend_factory=lambda: None)
    w, _default, _kind = win._field_widgets["face_thresh"]
    w.setValue(0.123)
    cfg = win._collect_cfg()
    assert cfg.face_thresh == pytest.approx(0.123)
    win.face_thresh.setValue(0.321)
    cfg = win._collect_cfg()
    assert cfg.face_thresh == pytest.approx(0.321)


def test_curate_tab_full_reference_knob_argv(gui, monkeypatch, tmp_path):
    """The curate tab forwards every knob to the port's curator CLI with
    the reference arg names."""
    win = gui.MainWindow(backend_factory=lambda: None)
    expected = {"sharp-min", "scene-sim", "scene-time-gap",
                "scene-nn-window", "dedup-hamm", "scene-dedup",
                "scene-soft-cap", "scene-soft-penalty", "profile-yaw",
                "div-bg", "div-face", "closeup-boost", "closeup-thr"}
    assert set(win.cur_knobs) == expected
    captured = {}
    done = threading.Event()

    def fake_main(argv):
        captured["argv"] = list(argv)
        done.set()
        return 0

    import person_capture_tpu_torch.curator.__main__ as cm

    monkeypatch.setattr(cm, "main", fake_main)
    win.cur_pool.setText(str(tmp_path))
    win.cur_out.setText(str(tmp_path / "o"))
    win.cur_knobs["sharp-min"].setValue(0.2)
    win.cur_knobs["scene-dedup"].setValue(3)
    win.cur_scene_aware.setChecked(False)
    win.cur_assume_id.setChecked(True)
    win.cur_quotas.setText('{"closeup": [1, 5]}')
    win.on_curate()
    assert done.wait(timeout=30)
    args = cm.build_parser().parse_args(captured["argv"])
    assert args.sharp_min == pytest.approx(0.2)
    assert args.scene_dedup == 3 and args.scene_aware == 0
    assert args.assume_identity is True
    assert args.quotas == '{"closeup": [1, 5]}'
    assert args.ref == ""
    assert args.div_bg == 1.0 and args.closeup_boost == 0.25


def _set_field(win, name, value):
    win._field_widgets[name][0].setText(value)


def test_default_backend_builds_on_the_cpu_when_asked(gui):
    """The device field set to ``cpu``: the default face backend (SCRFD-2.5G
    and the bundled ArcFace, det 640, bf16) and the person backend build
    on the CPU and run a frame there."""
    from person_capture_tpu_torch.models import arcface as AF

    win = gui.MainWindow()
    _set_field(win, "device", "cpu")
    cfg = win._collect_cfg()
    assert cfg.device == "cpu"
    face = win._default_backend()
    inner = face.inner
    assert inner.device.type == "cpu" and inner.det_size == 640
    assert inner.dtype == torch.bfloat16
    assert inner.embed_dim == AF.SYNTH_R18.embed_dim
    frame = np.full((1, 120, 160, 3), 90, np.uint8)
    out = face.extract_batch(frame, np.ones(1, bool))
    assert out["feats"].shape[-1] == inner.embed_dim
    person = win._aux_factories(cfg)["person"]()
    assert person.device.type == "cpu"


def test_default_backend_without_a_card_fails_the_run(gui, synth, tmp_path,
                                                      monkeypatch):
    """The device field left at ``cuda`` with no card: Start ends the run
    with finished(False, ...) naming the missing device; nothing moves to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sv, ref_path = synth
    win = gui.MainWindow()
    win.video_edit.setText(sv.path)
    win.ref_list.addItem(ref_path)
    win.out_edit.setText(str(tmp_path / "out"))
    win.curate_enable.setChecked(False)
    win.on_start()
    _join(win.bridge)
    assert win.cfg.device == "cuda"
    log = "\n".join(win.log_pane.lines)
    assert "FAILED" in log and "no CUDA device" in log, log
    assert not os.path.isfile(str(tmp_path / "out" / "index.csv"))
