"""What the benchmark attaches to the port's objects from outside.

The port's face backends are wrapped per instance (no file of the port is
changed): each call into the detector counts the valid frames it was given
and the face slots it kept, each main-pass combined step is recorded (its
frame indices, valid flags and the faces and persons it returned) for the
comparison with the reference, and the engine's curator call and bank are
timed and copied. In a traced run the tower call and the engine's phases
also open ``torch.profiler.record_function`` ranges.

``faults`` plants the checks' faults in the timed path: ``"alter"`` turns
the embedding of the first kept face of each main-pass batch, ``"half"``
drops the faces of the second half of each main-pass batch's frames.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict
from typing import Dict, List

import numpy as np

EMBED_RANGE = "pb.embed"


def _range(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


class Probe:
    def __init__(self, faces, trace: bool = False, faults=()):
        self.trace = bool(trace)
        self.faults = set(faults)
        self.video = -1
        self.record = False
        # per video: canvas -> valid frames, kept face slots, valid
        # main-pass frames, seconds in the curator
        self.det_frames: Dict[int, Counter] = defaultdict(Counter)
        self.kept: Counter = Counter()
        self.person_frames: Counter = Counter()
        self.curate_s: Dict[int, float] = defaultdict(float)
        self.batches: List[Dict] = []
        self.bank = None
        self._undo = []
        for face in faces:
            self._wrap_face(face)

    # ---- the face backends ---------------------------------------------
    def _count(self, face, valid, mask) -> None:
        self.det_frames[self.video][int(face.det_size)] += int(
            np.asarray(valid).sum())
        self.kept[self.video] += int(np.asarray(mask).sum())

    def _wrap_face(self, face) -> None:
        submit = face.submit_batch

        def submit_batch(frames, valid, frame_idxs=None):
            fetch = submit(frames, valid, frame_idxs)

            def fetched():
                out = fetch()
                self._count(face, valid, out["mask"])
                return out

            return fetched

        face.submit_batch = submit_batch
        self._undo.append(lambda: delattr(face, "submit_batch"))
        if hasattr(face, "submit_wire_with_person"):
            combined = face.submit_wire_with_person

            def submit_wire_with_person(person, frames, valid,
                                        frame_idxs=None):
                fetch = combined(person, frames, valid, frame_idxs)
                shape = tuple(np.asarray(frames).shape[1:3])

                def fetched():
                    out, persons = fetch()
                    self._plant(out, valid)
                    self._count(face, valid, out["mask"])
                    self.person_frames[self.video] += int(
                        np.asarray(valid).sum())
                    if self.record:
                        self.batches.append({
                            "video": self.video, "shape": shape,
                            "idxs": np.asarray(frame_idxs).copy(),
                            "valid": np.asarray(valid, bool).copy(),
                            "faces": {k: np.array(v) for k, v in out.items()},
                            "persons": {k: np.array(v)
                                        for k, v in persons.items()}})
                    return out, persons

                return fetched

            face.submit_wire_with_person = submit_wire_with_person
            self._undo.append(
                lambda: delattr(face, "submit_wire_with_person"))
        if self.trace:
            encode = face._encode

            def encoded(chips):
                with _range(EMBED_RANGE, True):
                    return encode(chips)

            face._encode = encoded
            self._undo.append(lambda: setattr(face, "_encode", encode))

    def _plant(self, out: Dict, valid) -> None:
        valid = np.asarray(valid, bool)
        if "half" in self.faults:
            n = int(valid.sum())
            out["mask"][n // 2:] = False
        if "alter" in self.faults:
            kept = np.argwhere(out["mask"] & valid[:, None])
            if len(kept):
                i, j = kept[0]
                out["feats"][i, j] = np.roll(out["feats"][i, j], 1)

    # ---- the engine ------------------------------------------------------
    def attach(self, engine) -> None:
        """Time the engine's curator call and copy the bank it seeds."""
        seed, curate = engine.seed_bank, engine._run_curator

        def seed_bank(paths):
            with _range("pb.seed_bank", self.trace):
                bank = seed(paths)
            mat = bank.matrix()
            self.bank = None if mat is None else np.array(mat)
            return bank

        def run_curator(*a, **kw):
            t0 = time.perf_counter()
            try:
                with _range("pb.curate", self.trace):
                    return curate(*a, **kw)
            finally:
                self.curate_s[self.video] += time.perf_counter() - t0

        engine.seed_bank, engine._run_curator = seed_bank, run_curator

    @contextlib.contextmanager
    def phases(self):
        """Name the engine's pre-scan and main pass in a traced run."""
        if not self.trace:
            yield
            return
        from person_capture_tpu_torch.pipeline import engine as E

        saved = E.run_prescan, E.run_main_pass

        def prescan(*a, **kw):
            with _range("pb.prescan", True):
                return saved[0](*a, **kw)

        def mainpass(*a, **kw):
            with _range("pb.mainpass", True):
                return saved[1](*a, **kw)

        E.run_prescan, E.run_main_pass = prescan, mainpass
        try:
            yield
        finally:
            E.run_prescan, E.run_main_pass = saved

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


def summed_stages(summaries) -> Dict[str, float]:
    """StepTimer summaries of several runs → seconds per stage."""
    out: Dict[str, float] = defaultdict(float)
    for s in summaries:
        for k, v in s.items():
            out[k] += float(v["total_s"])
    return dict(out)


def summed_counters(counters) -> Dict[str, int]:
    """StepTimer counters of several runs → their sums."""
    out: Dict[str, int] = defaultdict(int)
    for c in counters:
        for k, v in c.items():
            out[k] += int(v)
    return dict(out)
