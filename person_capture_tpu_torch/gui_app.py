"""Qt GUI shell over the Engine (the torch port's copy of
``person_capture_tpu/gui_app.py``).

Desktop surface equivalent to the reference MainWindow
(person_capture/gui_app.py:13490-19021) — video/reference pickers with a
multi-ref list, live-tunable controls bound to SessionConfig, preview pane,
log pane, progress bar, preset save/load, QSettings persistence, a curate
tab and an update menu — reduced to the essentials because the pipeline
itself lives in the headless Engine (pipeline/engine.py), not in the window.

Requires PySide6; importing this module without it raises ImportError with
a clear message. Everything the GUI does is also reachable from the CLI
(person_capture_tpu_torch.main) and the Engine API. The models run on
``cfg.device`` (the "device" field of the settings tab, ``cuda`` by
default), which raises without a card rather than moving to the CPU.

    python -m person_capture_tpu_torch.gui_app
"""

from __future__ import annotations

import json
import os
import sys
import threading

try:
    from PySide6 import QtCore, QtGui, QtWidgets
except ImportError as e:  # pragma: no cover - GUI host only
    raise ImportError(
        "person_capture_tpu_torch.gui_app requires PySide6; use "
        "`python -m person_capture_tpu_torch.main` for the headless CLI"
    ) from e

import numpy as np

from .config import LIVE_KEYS, SessionConfig
from .pipeline.engine import Engine

# the JAX package's QSettings keys, kept so that a user's saved video,
# references and output folder carry over between the two packages
ORG, APP = "person_capture_tpu", "PersonCaptureTPU"


class EngineBridge(QtCore.QObject):
    """Qt signal surface mirroring the reference Processor's signals."""

    status = QtCore.Signal(str)
    progress = QtCore.Signal(float)
    preview = QtCore.Signal(object, int)
    hit = QtCore.Signal(object)
    finished = QtCore.Signal(bool, str)

    def __init__(self, cfg: SessionConfig, backend_factory,
                 aux_factories=None):
        super().__init__()
        self.cfg = cfg
        self._backend_factory = backend_factory
        # optional zero-arg factories: {"person", "reid", "fullframe"} —
        # wired lazily so a face_only run never pays their build
        self._aux_factories = dict(aux_factories or {})
        self._engine = None
        self._thread = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        # the Engine exists BEFORE the worker thread spins up so that
        # pause/stop/seek clicked during the (slow) backend compile are not
        # silently dropped; the heavy backend build itself stays on the
        # worker thread via LazyBackend (first extract triggers the factory)
        from .pipeline.backends import LazyBackend

        def lazy(name):
            f = self._aux_factories.get(name)
            return LazyBackend(f) if f is not None else None

        self._engine = Engine(
            self.cfg, LazyBackend(self._backend_factory),
            person_backend=lazy("person"),
            reid_backend=lazy("reid"),
            fullframe_backend=lazy("fullframe"),
            status=self.status.emit,
            progress=self.progress.emit,
            on_hit=self.hit.emit,
            on_preview=lambda img, idx: self.preview.emit(img, idx))

        def run():
            try:
                result = self._engine.run()
                self.finished.emit(result.ok, result.error)
            except Exception as e:  # noqa: BLE001
                self.finished.emit(False, str(e))

        self._thread = threading.Thread(target=run, name="pc.engine",
                                        daemon=True)
        self._thread.start()

    def pause(self, value: bool):
        if self._engine:
            self._engine.pause(value)

    def stop(self):
        if self._engine:
            self._engine.stop()

    def update_cfg(self, **kv):
        if self._engine:
            self._engine.update_cfg(**kv)

    def seek(self, frame_idx: int):
        if self._engine:
            self._engine.seek(int(frame_idx))

    def step(self):
        if self._engine:
            self._engine.step()

    def set_speed(self, speed: float):
        if self._engine:
            self._engine.set_speed(float(speed))


def _face_backend(cfg: SessionConfig, device, **kw):
    """SCRFD-2.5G and ArcFace from the bundled weights (the JAX window's
    defaults: det 640, bf16), on ``device``. Both model families resolve
    as main.py does: a random-init ArcFace detects faces fine but every
    identity distance is noise, so a default GUI run would silently never
    match the reference."""
    from .models import arcface as AF
    from .models.zoo import bundled_weights_path, resolve_weights
    from .pipeline.backends import ScrfdArcFaceBackend

    arc_name = ("arcface_synth" if bundled_weights_path("arcface_synth")
                else "w600k_r50")
    return ScrfdArcFaceBackend(
        scrfd_weights=resolve_weights("auto", "scrfd_2.5g"),
        arcface_cfg=AF.CONFIGS.get(arc_name, AF.W600K_R50),
        arcface_weights=resolve_weights("auto", arc_name),
        max_faces=cfg.tpu_max_faces, device=device, **kw)


def _bgr_to_qimage(bgr: np.ndarray) -> QtGui.QImage:
    h, w = bgr.shape[:2]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    return QtGui.QImage(rgb.data, w, h, 3 * w,
                        QtGui.QImage.Format_RGB888).copy()


class MainWindow(QtWidgets.QMainWindow):
    def __init__(self, backend_factory=None, aux_factories=None):
        super().__init__()
        self.setWindowTitle("PersonCapture (CUDA)")
        self.cfg = SessionConfig()
        self.backend_factory = backend_factory or self._default_backend
        self.aux_factories = aux_factories
        self.bridge = None
        self._build_ui()
        self._restore_settings()
        # baseline for edited-since-last-sync detection in _collect_cfg
        self._snapshot_quick()

    # ------------------------------------------------------------------
    def _default_backend(self):
        from .main import resolve_device
        from .pipeline.recovery import RecoveringFaceBackend, RecoveryPolicy

        backend = _face_backend(self.cfg, resolve_device(self.cfg))
        return RecoveringFaceBackend(backend,
                                     RecoveryPolicy.from_config(self.cfg))

    # ------------------------------------------------------------------
    def _aux_factories(self, cfg: SessionConfig):
        """Person / ReID / full-frame-rescue factories the run's config
        actually needs (mirrors main.py's conditional construction; the
        reference GUI always has all models available, gui_app.py:4490-
        4515). Each is LazyBackend-wrapped by the bridge, so nothing
        builds until the pipeline first touches it."""
        aux = {}
        if (cfg.match_mode != "face_only"
                or not cfg.skip_yolo_when_faceonly
                or cfg.compose_detect_person_for_face):
            def person():
                from .main import resolve_device, resolve_yolo
                from .pipeline.backends import YoloPersonBackend

                yolo_cfg, yolo_w = resolve_yolo(cfg.yolo_model)
                return YoloPersonBackend(cfg=yolo_cfg,
                                         conf=cfg.min_det_conf,
                                         weights=yolo_w,
                                         device=resolve_device(cfg))

            aux["person"] = person
        if cfg.match_mode in ("either", "both", "reid_only"):
            cfg.disable_reid = False

            def reid():
                from .main import resolve_device, resolve_reid
                from .pipeline.backends import ClipReidBackend

                reid_cfg, reid_w = resolve_reid(cfg.reid_backbone, "auto")
                return ClipReidBackend(cfg=reid_cfg, weights=reid_w,
                                       device=resolve_device(cfg))

            aux["reid"] = reid
        if (cfg.face_fullframe_when_missed
                and int(cfg.face_fullframe_imgsz) > 640):
            def fullframe():
                from .main import resolve_device

                return _face_backend(cfg, resolve_device(cfg),
                                     det_size=int(cfg.face_fullframe_imgsz),
                                     score_thresh=cfg.face_det_conf)

            aux["fullframe"] = fullframe
        return aux

    def _build_ui(self):
        central = QtWidgets.QWidget()
        layout = QtWidgets.QHBoxLayout(central)

        # left: controls
        form_w = QtWidgets.QWidget()
        form = QtWidgets.QFormLayout(form_w)
        self.video_edit = QtWidgets.QLineEdit()
        pick_v = QtWidgets.QPushButton("…")
        pick_v.clicked.connect(self._pick_video)
        row = QtWidgets.QHBoxLayout()
        row.addWidget(self.video_edit)
        row.addWidget(pick_v)
        form.addRow("Video", row)

        self.ref_list = QtWidgets.QListWidget()
        self.ref_list.setMaximumHeight(80)
        ref_btns = QtWidgets.QHBoxLayout()
        add_ref = QtWidgets.QPushButton("Add ref…")
        add_ref.clicked.connect(self._add_ref)
        del_ref = QtWidgets.QPushButton("Remove")
        del_ref.clicked.connect(
            lambda: [self.ref_list.takeItem(self.ref_list.currentRow())])
        ref_btns.addWidget(add_ref)
        ref_btns.addWidget(del_ref)
        form.addRow("References", self.ref_list)
        form.addRow("", ref_btns)

        self.out_edit = QtWidgets.QLineEdit("output")
        form.addRow("Output dir", self.out_edit)
        self.ratio_edit = QtWidgets.QLineEdit(self.cfg.ratio)
        form.addRow("Ratios", self.ratio_edit)

        self.face_thresh = QtWidgets.QDoubleSpinBox()
        self.face_thresh.setRange(0.0, 2.0)
        self.face_thresh.setSingleStep(0.01)
        self.face_thresh.setValue(self.cfg.face_thresh)
        form.addRow("Face thresh", self.face_thresh)

        self.match_mode = QtWidgets.QComboBox()
        self.match_mode.addItems(["face_only", "either", "both", "reid_only"])
        form.addRow("Match mode", self.match_mode)

        self.frame_stride = QtWidgets.QSpinBox()
        self.frame_stride.setRange(1, 100)
        self.frame_stride.setValue(self.cfg.frame_stride)
        form.addRow("Frame stride", self.frame_stride)

        self.min_gap = QtWidgets.QDoubleSpinBox()
        self.min_gap.setRange(0.0, 60.0)
        self.min_gap.setValue(self.cfg.min_gap_sec)
        form.addRow("Min gap (s)", self.min_gap)

        self.prescan_enable = QtWidgets.QCheckBox("Pre-scan spans")
        self.prescan_enable.setChecked(self.cfg.prescan_enable)
        form.addRow(self.prescan_enable)
        self.curate_enable = QtWidgets.QCheckBox("Curate after run")
        self.curate_enable.setChecked(self.cfg.curate_enable)
        form.addRow(self.curate_enable)

        btns = QtWidgets.QHBoxLayout()
        self.start_btn = QtWidgets.QPushButton("Start")
        self.start_btn.clicked.connect(self.on_start)
        self.pause_btn = QtWidgets.QPushButton("Pause")
        self.pause_btn.setCheckable(True)
        self.pause_btn.toggled.connect(self.on_pause)
        self.stop_btn = QtWidgets.QPushButton("Stop")
        self.stop_btn.clicked.connect(self.on_stop)
        # step-while-paused + playback speed (reference Processor
        # step/set_speed commands, gui_app.py:3543-3593)
        self.step_btn = QtWidgets.QPushButton("Step")
        self.step_btn.clicked.connect(
            lambda: self.bridge and self.bridge.step())
        self.speed_box = QtWidgets.QDoubleSpinBox()
        self.speed_box.setRange(0.0, 16.0)
        self.speed_box.setSingleStep(0.25)
        self.speed_box.setValue(0.0)
        self.speed_box.setToolTip("playback speed ×realtime (0 = full speed)")
        self.speed_box.valueChanged.connect(
            lambda v: self.bridge and self.bridge.set_speed(v))
        for b in (self.start_btn, self.pause_btn, self.stop_btn,
                  self.step_btn):
            btns.addWidget(b)
        btns.addWidget(self.speed_box)
        form.addRow(btns)

        self.progress_bar = QtWidgets.QProgressBar()
        self.progress_bar.setRange(0, 1000)
        form.addRow(self.progress_bar)

        layout.addWidget(form_w, 0)

        # right: preview + seek + log
        right = QtWidgets.QVBoxLayout()
        self.preview_label = QtWidgets.QLabel("preview")
        self.preview_label.setMinimumSize(480, 270)
        self.preview_label.setAlignment(QtCore.Qt.AlignCenter)
        right.addWidget(self.preview_label, 1)

        # seek slider + keyframe jumps (reference gui_app.py:17683-17759)
        seek_row = QtWidgets.QHBoxLayout()
        self.kf_prev_btn = QtWidgets.QPushButton("⏮ key")
        self.kf_prev_btn.clicked.connect(lambda: self._jump_keyframe(-1))
        self.seek_slider = QtWidgets.QSlider(QtCore.Qt.Horizontal)
        self.seek_slider.setRange(0, 0)
        self.seek_slider.sliderReleased.connect(self._on_seek_released)
        self.kf_next_btn = QtWidgets.QPushButton("key ⏭")
        self.kf_next_btn.clicked.connect(lambda: self._jump_keyframe(+1))
        seek_row.addWidget(self.kf_prev_btn)
        seek_row.addWidget(self.seek_slider, 1)
        seek_row.addWidget(self.kf_next_btn)
        self.seek_pos_label = QtWidgets.QLabel("0")
        seek_row.addWidget(self.seek_pos_label)
        right.addLayout(seek_row)

        self.log_pane = QtWidgets.QPlainTextEdit()
        self.log_pane.setReadOnly(True)
        self.log_pane.setMaximumBlockCount(2000)
        right.addWidget(self.log_pane, 1)
        layout.addLayout(right, 1)

        tabs = QtWidgets.QTabWidget()
        tabs.addTab(central, "Capture")
        tabs.addTab(self._build_settings_tab(), "All settings")
        tabs.addTab(self._build_curate_tab(), "Curate")
        self.setCentralWidget(tabs)
        self._build_menu()
        self._keyframes = []

    # ------------------------------------------------------------------
    def _build_settings_tab(self) -> QtWidgets.QWidget:
        """Every SessionConfig field as a typed control, grouped into
        collapsible sections generated from the dataclass (the reference
        hand-builds ~200 widgets, gui_app.py:13558-15090; here new config
        keys appear automatically). Fields in the LIVE set push
        ``update_cfg`` to the running engine on change."""
        from .utils.cfgbind import grouped_fields, widget_kind

        self._field_widgets = {}
        scroll = QtWidgets.QScrollArea()
        scroll.setWidgetResizable(True)
        host = QtWidgets.QWidget()
        vbox = QtWidgets.QVBoxLayout(host)
        for section, fields in grouped_fields().items():
            box = QtWidgets.QGroupBox(section)
            box.setCheckable(True)   # poor-man's collapsible
            form = QtWidgets.QFormLayout(box)
            for name, default in fields:
                current = getattr(self.cfg, name, default)
                kind = widget_kind(default)
                if kind == "check":
                    w = QtWidgets.QCheckBox()
                    w.setChecked(bool(current))
                    sig = w.toggled
                elif kind == "int":
                    w = QtWidgets.QSpinBox()
                    w.setRange(-2 ** 30, 2 ** 30)
                    w.setValue(int(current))
                    sig = w.valueChanged
                elif kind == "float":
                    w = QtWidgets.QDoubleSpinBox()
                    w.setRange(-1e9, 1e9)
                    w.setDecimals(4)
                    w.setValue(float(current))
                    sig = w.valueChanged
                else:  # tuple | text
                    w = QtWidgets.QLineEdit(
                        ", ".join(str(v) for v in current)
                        if isinstance(current, tuple) else str(current))
                    sig = w.editingFinished
                w.setToolTip(f"{type(default).__name__}: {name}")
                self._field_widgets[name] = (w, default, kind)
                if name in LIVE_KEYS:
                    sig.connect(lambda *_a, n=name: self._push_live(n))
                form.addRow(name, w)
            box.toggled.connect(
                lambda on, b=box: [c.widget().setVisible(on)
                                   for c in (b.layout().itemAt(i)
                                             for i in range(b.layout().count()))
                                   if c and c.widget()])
            vbox.addWidget(box)
        vbox.addStretch(1)
        scroll.setWidget(host)
        return scroll

    def _widget_value(self, name: str):
        from .utils.cfgbind import coerce_field_value

        w, default, kind = self._field_widgets[name]
        if kind == "check":
            raw = w.isChecked()
        elif kind in ("int", "float"):
            raw = w.value()
        else:
            raw = w.text()
        return coerce_field_value(default, raw)

    def _push_live(self, name: str):
        """LIVE key changed mid-run → push to the engine command queue
        (reference `_apply_live_cfg`, gui_app.py:15947)."""
        try:
            value = self._widget_value(name)
        except (ValueError, TypeError):
            return
        setattr(self.cfg, name, value)
        if self.bridge:
            self.bridge.update_cfg(**{name: value})

    # ------------------------------------------------------------------
    def _on_seek_released(self):
        pos = int(self.seek_slider.value())
        self.seek_pos_label.setText(str(pos))
        if self.bridge:
            self.bridge.seek(pos)

    def _jump_keyframe(self, direction: int):
        if not self._keyframes:
            self._load_keyframes()
        pos = int(self.seek_slider.value())
        if direction < 0:
            cands = [k for k in self._keyframes if k < pos]
            target = max(cands) if cands else 0
        else:
            cands = [k for k in self._keyframes if k > pos]
            target = min(cands) if cands else pos
        self.seek_slider.setValue(int(target))
        self._on_seek_released()

    def _load_keyframes(self):
        path = self.video_edit.text()
        if not path or not os.path.isfile(path):
            return
        try:
            from .video.keyframes import read_keyframes
            from .video.reader import Cv2Reader

            r = Cv2Reader(path)
            meta = r.meta()
            r.release()
            self.seek_slider.setRange(0, max(0, meta.total_frames - 1))
            self._keyframes = list(
                read_keyframes(path, meta.fps, meta.total_frames))
        except Exception as e:  # noqa: BLE001
            self._log(f"keyframe index failed: {e}")

    def _build_curate_tab(self) -> QtWidgets.QWidget:
        """Curate tab (reference: gui_curate_tab.add_tab_to): pool/ref/out
        pickers + key tunables, running the Curator on a worker thread."""
        w = QtWidgets.QWidget()
        form = QtWidgets.QFormLayout(w)
        self.cur_pool = QtWidgets.QLineEdit()
        self.cur_ref = QtWidgets.QLineEdit()
        self.cur_out = QtWidgets.QLineEdit("dataset_out")
        for label, edit, mode in (("Pool dir", self.cur_pool, "dir"),
                                  ("Reference", self.cur_ref, "file"),
                                  ("Out dir", self.cur_out, None)):
            row = QtWidgets.QHBoxLayout()
            row.addWidget(edit)
            if mode:
                btn = QtWidgets.QPushButton("…")

                def pick(_=None, e=edit, m=mode):
                    if m == "dir":
                        p = QtWidgets.QFileDialog.getExistingDirectory(self)
                    else:
                        p, _2 = QtWidgets.QFileDialog.getOpenFileName(self)
                    if p:
                        e.setText(p)

                btn.clicked.connect(pick)
                row.addWidget(btn)
            form.addRow(label, row)
        self.cur_max = QtWidgets.QSpinBox()
        self.cur_max.setRange(1, 10000)
        self.cur_max.setValue(self.cfg.curate_max_images)
        form.addRow("Max images", self.cur_max)
        self.cur_fd_gate = QtWidgets.QDoubleSpinBox()
        self.cur_fd_gate.setRange(0.0, 2.0)
        self.cur_fd_gate.setSingleStep(0.01)
        self.cur_fd_gate.setValue(self.cfg.curate_fd_gate)
        form.addRow("fd gate", self.cur_fd_gate)
        self.cur_lambda = QtWidgets.QDoubleSpinBox()
        self.cur_lambda.setRange(0.0, 1.0)
        self.cur_lambda.setSingleStep(0.05)
        self.cur_lambda.setValue(self.cfg.curate_lambda)
        form.addRow("MMR λ", self.cur_lambda)
        # full reference tunable set (reference CurateTab ~25 controls,
        # gui_curate_tab.py:26-711); each maps 1:1 to a curator CLI flag,
        # defaults = the reference CLI defaults (dataset_curator.py:1275+)
        self.cur_knobs = {}
        for arg, label, kind, lo, hi, step, dv in (
                ("sharp-min", "Sharpness min", "f", 0.0, 1.0, 0.01, 0.10),
                ("scene-sim", "Scene similarity", "f", 0.0, 1.0, 0.01, 0.92),
                ("scene-time-gap", "Scene time gap (s)", "f", 0.0, 60.0,
                 0.5, 4.0),
                ("scene-nn-window", "Scene NN window", "i", 0, 4096, 1, 64),
                ("dedup-hamm", "Dedup hamming", "i", 0, 64, 1, 7),
                ("scene-dedup", "In-scene dedup hamming", "i", 0, 64, 1, 8),
                ("scene-soft-cap", "Scene soft cap (0=off)", "i", 0, 1000,
                 1, 0),
                ("scene-soft-penalty", "Scene soft penalty", "f", 0.0, 10.0,
                 0.01, 0.08),
                ("profile-yaw", "Profile yaw (deg)", "f", 0.0, 90.0, 1.0,
                 50.0),
                ("div-bg", "Diversity weight: background", "f", 0.0, 10.0,
                 0.05, 1.0),
                ("div-face", "Diversity weight: face", "f", 0.0, 10.0,
                 0.05, 0.6),
                ("closeup-boost", "Close-up boost", "f", 0.0, 5.0, 0.05,
                 0.25),
                ("closeup-thr", "Close-up threshold", "f", 0.0, 1.0, 0.01,
                 0.33)):
            if kind == "i":
                sb = QtWidgets.QSpinBox()
                sb.setRange(int(lo), int(hi))
                sb.setValue(int(dv))
            else:
                sb = QtWidgets.QDoubleSpinBox()
                sb.setRange(lo, hi)
                sb.setSingleStep(step)
                sb.setValue(dv)
            form.addRow(label, sb)
            self.cur_knobs[arg] = sb
        self.cur_scene_aware = QtWidgets.QCheckBox("Scene-aware selection")
        self.cur_scene_aware.setChecked(True)
        form.addRow(self.cur_scene_aware)
        self.cur_assume_id = QtWidgets.QCheckBox(
            "Assume identity (skip fd gate)")
        form.addRow(self.cur_assume_id)
        self.cur_quotas = QtWidgets.QLineEdit()
        form.addRow("Quotas JSON {cat: [min, max]}", self.cur_quotas)
        run_btn = QtWidgets.QPushButton("Run curation")
        run_btn.clicked.connect(self.on_curate)
        form.addRow(run_btn)
        self.cur_result = QtWidgets.QPlainTextEdit()
        self.cur_result.setReadOnly(True)
        form.addRow(self.cur_result)
        return w

    def on_curate(self):
        pool = self.cur_pool.text()
        ref = self.cur_ref.text()
        out = self.cur_out.text() or "dataset_out"
        if not pool:
            self.cur_result.appendPlainText("select pool dir")
            return

        # widget values are read on the UI thread; the worker only sees
        # plain strings. Omitting the reference turns on assume-identity
        # in the CLI, exactly like the reference curator.
        argv = ["--pool", pool, "--out", out,
                "--max", str(self.cur_max.value()),
                "--fd-max", str(self.cur_fd_gate.value()),
                "--mmr-alpha", str(self.cur_lambda.value()),
                "--scene-aware",
                "1" if self.cur_scene_aware.isChecked() else "0"]
        for arg, sb in self.cur_knobs.items():
            argv += [f"--{arg}", str(sb.value())]
        if self.cur_assume_id.isChecked():
            argv.append("--assume-identity")
        quotas = self.cur_quotas.text().strip()
        if quotas:
            argv += ["--quotas", quotas]
        if ref:
            argv += ["--ref", ref]

        def run():
            try:
                from .curator.__main__ import main as curate_main

                rc = curate_main(argv)
                QtCore.QMetaObject.invokeMethod(
                    self.cur_result, "appendPlainText",
                    QtCore.Qt.QueuedConnection,
                    QtCore.Q_ARG(str, f"curation finished rc={rc}"))
            except Exception as e:  # noqa: BLE001
                QtCore.QMetaObject.invokeMethod(
                    self.cur_result, "appendPlainText",
                    QtCore.Qt.QueuedConnection,
                    QtCore.Q_ARG(str, f"curation failed: {e}"))

        threading.Thread(target=run, daemon=True,
                         name="pc.curate").start()

    def _build_menu(self):
        m = self.menuBar()
        filem = m.addMenu("&File")
        save_preset = filem.addAction("Save preset…")
        save_preset.triggered.connect(self._save_preset)
        load_preset = filem.addAction("Load preset…")
        load_preset.triggered.connect(self._load_preset)
        helpm = m.addMenu("&Help")
        upd = helpm.addAction("Check for updates")
        upd.triggered.connect(self._check_updates)

    # ------------------------------------------------------------------
    def _pick_video(self):
        p, _ = QtWidgets.QFileDialog.getOpenFileName(
            self, "Video", "", "Video (*.mp4 *.mkv *.mov *.webm *.avi)")
        if p:
            self.video_edit.setText(p)

    def _add_ref(self):
        ps, _ = QtWidgets.QFileDialog.getOpenFileNames(
            self, "Reference photos", "", "Images (*.jpg *.jpeg *.png *.webp)")
        for p in ps:
            self.ref_list.addItem(p)

    def _quick_controls(self):
        """Capture-tab quick controls that DUPLICATE generated-tab fields:
        name -> (getter, setter)."""
        return {
            "ratio": (lambda: self.ratio_edit.text() or self.cfg.ratio,
                      self.ratio_edit.setText),
            "face_thresh": (self.face_thresh.value,
                            self.face_thresh.setValue),
            "match_mode": (self.match_mode.currentText,
                           self._set_match_mode),
            "frame_stride": (self.frame_stride.value,
                             self.frame_stride.setValue),
            "min_gap_sec": (self.min_gap.value, self.min_gap.setValue),
            "prescan_enable": (self.prescan_enable.isChecked,
                               self.prescan_enable.setChecked),
            "curate_enable": (self.curate_enable.isChecked,
                              self.curate_enable.setChecked),
        }

    def _set_match_mode(self, value) -> None:
        idx = self.match_mode.findText(str(value))
        if idx >= 0:
            self.match_mode.setCurrentIndex(idx)

    def _snapshot_quick(self) -> None:
        self._quick_last = {k: get()
                            for k, (get, _set) in
                            self._quick_controls().items()}

    def _sync_quick_from_cfg(self) -> None:
        """Push cfg values back into the quick controls and re-snapshot
        (after presets/collect, both tabs must show the same state)."""
        for name, (_get, set_) in self._quick_controls().items():
            try:
                set_(getattr(self.cfg, name))
            except (TypeError, ValueError):
                pass
        self._snapshot_quick()

    def _collect_cfg(self) -> SessionConfig:
        cfg = self.cfg
        # the generated settings tab binds every remaining field
        for name in getattr(self, "_field_widgets", {}):
            try:
                setattr(cfg, name, self._widget_value(name))
            except (ValueError, TypeError):
                pass
        cfg.video = self.video_edit.text()
        cfg.ref = ";".join(self.ref_list.item(i).text()
                           for i in range(self.ref_list.count()))
        cfg.out_dir = self.out_edit.text() or "output"
        # a quick control overrides the generated twin only when the USER
        # edited it since the last sync — an untouched stale widget must
        # not clobber a value changed in the All-settings tab
        last = getattr(self, "_quick_last", {})
        for name, (get, _set) in self._quick_controls().items():
            value = get()
            if name not in last or last[name] != value:
                setattr(cfg, name, value)
        self._sync_quick_from_cfg()
        return cfg

    def on_start(self):
        if (self.bridge is not None
                and getattr(self.bridge, "_thread", None) is not None
                and self.bridge._thread.is_alive()):
            # a second Start while running would orphan the first engine
            # (its thread lives only in the replaced bridge) and race two
            # writers on the same out_dir
            self._log("a run is already active — Stop it first")
            return
        cfg = self._collect_cfg()
        if not cfg.video or not cfg.ref:
            self._log("select a video and at least one reference photo")
            return
        # default factory only: injected test doubles bring their own
        # world (an oracle face backend + default-family rescue would
        # score one RefBank in two incompatible embedding spaces)
        aux = (self._aux_factories(cfg)
               if self.backend_factory == self._default_backend else
               dict(self.aux_factories or {}))
        self.bridge = EngineBridge(cfg, self.backend_factory, aux)
        self.bridge.status.connect(self._log)
        self.bridge.progress.connect(
            lambda p: self.progress_bar.setValue(int(p * 1000)))
        self.bridge.preview.connect(self._show_preview)
        self.bridge.hit.connect(
            lambda h: self._log(f"hit f{h.frame} fd={h.face_dist}"))
        self.bridge.finished.connect(
            lambda ok, err: self._log("done" if ok else f"FAILED: {err}"))
        self._load_keyframes()
        self.bridge.start()

    def on_pause(self, value: bool):
        if self.bridge:
            self.bridge.pause(value)

    def on_stop(self):
        if self.bridge:
            self.bridge.stop()

    def _show_preview(self, img, idx):
        qimg = _bgr_to_qimage(img)
        self.preview_label.setPixmap(QtGui.QPixmap.fromImage(qimg).scaled(
            self.preview_label.size(), QtCore.Qt.KeepAspectRatio,
            QtCore.Qt.SmoothTransformation))
        if not self.seek_slider.isSliderDown():
            self.seek_slider.setValue(int(idx))
            self.seek_pos_label.setText(str(int(idx)))

    def _log(self, msg: str):
        self.log_pane.appendPlainText(str(msg))

    # ------------------------------------------------------------------
    def _save_preset(self):
        p, _ = QtWidgets.QFileDialog.getSaveFileName(self, "Preset", "",
                                                     "JSON (*.json)")
        if p:
            with open(p, "w") as fh:
                fh.write(self._collect_cfg().to_json())

    def _load_preset(self):
        p, _ = QtWidgets.QFileDialog.getOpenFileName(self, "Preset", "",
                                                     "JSON (*.json)")
        if p:
            with open(p) as fh:
                self.cfg = SessionConfig.from_json(fh.read())
            self.face_thresh.setValue(self.cfg.face_thresh)
            self.frame_stride.setValue(self.cfg.frame_stride)
            self.min_gap.setValue(self.cfg.min_gap_sec)
            self.ratio_edit.setText(self.cfg.ratio)
            idx = self.match_mode.findText(self.cfg.match_mode)
            if idx >= 0:
                self.match_mode.setCurrentIndex(idx)
            self.prescan_enable.setChecked(self.cfg.prescan_enable)
            self.curate_enable.setChecked(self.cfg.curate_enable)
            # refresh the generated settings tab too — _collect_cfg reads
            # every generated widget back, so stale controls would silently
            # overwrite the loaded preset at Start (reference _apply_cfg,
            # gui_app.py:16592)
            self._apply_cfg_to_widgets()
            self._snapshot_quick()

    def _apply_cfg_to_widgets(self):
        for name, (w, default, kind) in getattr(self, "_field_widgets",
                                                {}).items():
            value = getattr(self.cfg, name, default)
            if kind == "check":
                w.setChecked(bool(value))
            elif kind == "int":
                w.setValue(int(value))
            elif kind == "float":
                w.setValue(float(value))
            else:
                w.setText(", ".join(str(v) for v in value)
                          if isinstance(value, tuple) else str(value))

    def _check_updates(self):
        """Network check/fetch runs off the UI thread (the reference's
        UpdateManager is async for the same reason); log lines marshal back
        through the queued-connection invoke."""
        from . import updater

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

        def log(msg):
            QtCore.QMetaObject.invokeMethod(
                self.log_pane, "appendPlainText", QtCore.Qt.QueuedConnection,
                QtCore.Q_ARG(str, str(msg)))

        def run():
            mgr = updater.UpdateManager(repo, status=log)
            avail, detail = mgr.check()
            log(f"update available: {avail} ({detail})")
            if avail:
                _ok, d = mgr.perform()
                log(f"update: {d}; restart to apply")

        threading.Thread(target=run, daemon=True, name="pc.update").start()

    # ------------------------------------------------------------------
    def _restore_settings(self):
        s = QtCore.QSettings(ORG, APP)
        self.video_edit.setText(s.value("video", ""))
        self.out_edit.setText(s.value("out_dir", "output"))
        for p in (s.value("refs", "") or "").split(";"):
            if p:
                self.ref_list.addItem(p)

    def closeEvent(self, event):
        s = QtCore.QSettings(ORG, APP)
        s.setValue("video", self.video_edit.text())
        s.setValue("out_dir", self.out_edit.text())
        s.setValue("refs", ";".join(self.ref_list.item(i).text()
                                    for i in range(self.ref_list.count())))
        if self.bridge:
            self.bridge.stop()
        super().closeEvent(event)


def main():
    app = QtWidgets.QApplication(sys.argv)
    win = MainWindow()
    win.resize(1100, 640)
    win.show()
    return app.exec()


if __name__ == "__main__":
    raise SystemExit(main())
