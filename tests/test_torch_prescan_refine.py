"""The port's span-edge refinement (``pipeline/prescan.refine_span_edges``)
against the JAX package's, and how it positions its reader.

The port walks each edge window forward from at most one seek (short
forward hops drain with ``skip``); the JAX package seeks to every sample.
With an ``OracleBackend`` (truth by frame index) both must refine the same
spans, and the frames the port hands its backend must be the frames a seek
per sample reads. One synthetic mp4 (160×120, 420 frames, mp4v) serves
every case. At the settings below an edge window is the edge ± 54 frames
(a stride of 24 plus a 1-s window at 30 fps) sampled every 3 frames.
"""

import numpy as np
import pytest

from person_capture_tpu.config import SessionConfig as JaxConfig
from person_capture_tpu.core.bank import RefBank as JaxBank
from person_capture_tpu.pipeline.backends import OracleBackend as JaxOracle
from person_capture_tpu.pipeline import prescan as jax_prescan
from person_capture_tpu_torch.config import SessionConfig
from person_capture_tpu_torch.core.bank import RefBank
from person_capture_tpu_torch.pipeline.backends import OracleBackend
from person_capture_tpu_torch.pipeline.prescan import (_cap_width,
                                                       _sample_fds,
                                                       refine_span_edges)
from person_capture_tpu_torch.utils.timing import StepTimer
from person_capture_tpu_torch.video.reader import (FORWARD_DRAIN_MAX,
                                                   Cv2Reader)
from person_capture_tpu_torch.video.synthetic import generate_video

TOTAL = 420
FPS = 30.0
SEARCH = 54   # max(pad 15, window 30) + stride 24
STEP = 3      # min(24 // 4, prescan_refine_stride_min 3)

# spans as the pre-scan hands them over; the clip's target is on screen in
# frames 8–70, 180–260 and 345–419
LAYOUTS = {
    # start window 106–214 (a seek: 106 frames ahead), end window 226–334
    # (drained from 215)
    "mid": [(160, 280)],
    # start window 0–54 where the reader stands, end window 56–164
    # (drained from 55): no seek at all
    "start_at_0": [(0, 110)],
    # the end edge is the clip's last frame (skipped); start window
    # 266–374 (a seek)
    "trailing": [(320, TOTAL - 1)],
    # four windows, each starting behind the one before: four backward
    # seeks
    "overlapping": [(170, 215), (235, 290)],
}
SEEKS = {"mid": 1, "start_at_0": 0, "trailing": 1, "overlapping": 4}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("refine") / "clip.mp4")
    return generate_video(path, width=160, height=120, fps=FPS,
                          total_frames=TOTAL,
                          segments=[(8, 70, 0), (180, 260, 0),
                                    (345, TOTAL - 1, 0)])


def _cfg(cls, batch):
    cfg = cls()
    cfg.prescan_stride = 24
    cfg.prescan_pad_sec = 0.5
    cfg.prescan_min_segment_sec = 0.5
    cfg.prescan_boundary_refine_sec = 1.0
    cfg.prescan_refine_stride_min = 3
    cfg.prescan_refine_budget_sec = 0.0   # unlimited: no edge is cut
    cfg.prescan_skip_trailing_refine = True
    cfg.tpu_batch_frames = batch
    cfg.face_quality_min = 0.0
    return cfg


def _bank(cls, backend):
    bank = cls(cap=8)
    bank.seed([backend.identity_feat(0)])
    return bank


def _windows(spans):
    """The sample indices of each edge window the refinement reads."""
    out = []
    for s, e in spans:
        for edge, is_start in ((s, True), (e, False)):
            if not is_start and e >= TOTAL - 1:
                continue
            lo, hi = max(0, edge - SEARCH), min(TOTAL - 1, edge + SEARCH)
            out.append(list(range(lo, hi + 1, STEP)))
    return out


class CountingReader(Cv2Reader):
    """``Cv2Reader`` that records its seeks (from, to), the frames it
    skips and its reads."""

    def __init__(self, path):
        super().__init__(path)
        self.seeks = []
        self.drained = 0
        self.reads = 0

    def seek(self, frame_idx):
        self.seeks.append((self.pos, int(frame_idx)))
        super().seek(frame_idx)

    def skip(self, count):
        done = super().skip(count)
        self.drained += done
        return done

    def read(self):
        self.reads += 1
        return super().read()


class DamagedReader(CountingReader):
    """A stream damaged at frame ``bad``: a skip across it stops there
    (``skip_short``), or the read of it fails once (``read_fails``)."""

    def __init__(self, path, bad, kind):
        super().__init__(path)
        self.bad, self.kind, self.tripped = bad, kind, False

    def skip(self, count):
        if (self.kind == "skip_short" and not self.tripped
                and self.pos <= self.bad < self.pos + count):
            self.tripped = True
            return super().skip(self.bad - self.pos)
        return super().skip(count)

    def read(self):
        if (self.kind == "read_fails" and not self.tripped
                and self.pos == self.bad):
            self.tripped = True
            self.reads += 1
            return None
        return super().read()


class RecordingOracle(OracleBackend):
    """Port ``OracleBackend`` that keeps each call's valid sample indices
    and the frames it was handed."""

    def __init__(self, sv):
        super().__init__(sv)
        self.calls = []
        self.frames = {}

    def extract_batch(self, frames, valid, frame_idxs=None):
        got = [int(frame_idxs[k]) for k in np.flatnonzero(valid)]
        self.calls.append(got)
        for k, i in zip(np.flatnonzero(valid), got):
            self.frames[i] = np.array(frames[k])
        return super().extract_batch(frames, valid, frame_idxs)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_refined_spans_equal_jax(clip, layout):
    spans = LAYOUTS[layout]
    port_backend, jax_backend = OracleBackend(clip), JaxOracle(clip)
    port = refine_span_edges(spans, lambda: Cv2Reader(clip.path),
                             port_backend, _cfg(SessionConfig, 8),
                             _bank(RefBank, port_backend), FPS, TOTAL)
    ref = jax_prescan.refine_span_edges(
        spans, lambda: Cv2Reader(clip.path), jax_backend,
        _cfg(JaxConfig, 8), _bank(JaxBank, jax_backend), FPS, TOTAL)
    assert port == ref
    assert port, "every layout keeps a span"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_refinement_walks_each_window_forward(clip, layout):
    spans = LAYOUTS[layout]
    windows = _windows(spans)
    readers = []

    def reopen():
        readers.append(CountingReader(clip.path))
        return readers[-1]

    backend = RecordingOracle(clip)
    timer = StepTimer()
    cfg = _cfg(SessionConfig, 64)   # one backend call per window
    refine_span_edges(spans, reopen, backend, cfg, _bank(RefBank, backend),
                      FPS, TOTAL, timer)
    (reader,) = readers

    # each window read in full, one read per sample, in order
    assert backend.calls == windows
    assert reader.reads == sum(len(w) for w in windows)
    # a seek only for a backward or long forward jump: at most one per
    # window, none into a window starting within FORWARD_DRAIN_MAX ahead
    assert len(reader.seeks) == SEEKS[layout] <= len(windows)
    for frm, to in reader.seeks:
        assert to < frm or to - frm > FORWARD_DRAIN_MAX, (frm, to)
    counters = timer.counters()
    assert counters.get("prescan.refine_seeks", 0) == len(reader.seeks)
    assert counters.get("prescan.refine_drained", 0) == reader.drained

    # the frames handed to the backend are those a seek per sample reads
    assert sorted(backend.frames) == sorted({i for w in windows for i in w})
    per_sample = Cv2Reader(clip.path)
    try:
        for i, frame in sorted(backend.frames.items()):
            per_sample.seek(i)
            want = _cap_width(per_sample.read(), cfg.prescan_max_width)
            assert np.array_equal(frame, want), i
    finally:
        per_sample.release()


@pytest.mark.parametrize("kind,bad", [("skip_short", 110),
                                      ("read_fails", 112)])
def test_damaged_stream_falls_back_to_seek(clip, kind, bad):
    """A skip that comes up short, or a read that fails, leaves the
    reader's position untrusted: the next sample is reached by a seek, and
    the fds are those of the JAX package's seek per sample on the same
    damaged stream."""
    idxs = list(range(106, 215, STEP))
    port_backend, jax_backend = RecordingOracle(clip), JaxOracle(clip)
    reader = DamagedReader(clip.path, bad, kind)
    try:
        fds = _sample_fds(reader, port_backend, _cfg(SessionConfig, 8),
                          _bank(RefBank, port_backend), idxs, StepTimer())
    finally:
        reader.release()
    parent = DamagedReader(clip.path, bad, kind)
    try:
        want = jax_prescan._sample_fds(parent, jax_backend,
                                       _cfg(JaxConfig, 8),
                                       _bank(JaxBank, jax_backend), idxs)
    finally:
        parent.release()

    assert reader.tripped
    nxt = 112 if kind == "skip_short" else bad + STEP
    assert reader.seeks == [(0, 106), (reader.seeks[1][0], nxt)]
    assert reader.reads == len(idxs)
    assert fds == want
    # the failed read loses its sample on both paths; a short skip loses
    # none
    lost = sorted(set(idxs) - set(port_backend.frames))
    assert lost == ([] if kind == "skip_short" else [bad])
