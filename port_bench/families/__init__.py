"""Model families, found by name: ``families/<kind>.py``.

A configuration section (``detector``, ``embedder``, ``person``) names its
family with ``kind``; the harness looks the module up here and calls it,
so a new architecture is a new file. Each family module exposes:

- ``reference(arch)``: the float32 model built from the frozen copy in
  ``port_bench/reference/`` at the section's ``arch``;
- ``load_reference(model, tree)``: a flax variable tree into that model;
- ``seeded(arch, seed, device)`` (optional): the tree for
  ``weights: "seeded:<seed>"``, drawn on ``device``;
- ``port_model(runtime)``: the port's module whose ``.cfg`` the run holds
  to ``arch`` (None where the runtime has no such model);
- ``load_port(backends, tree)``: the tree into the port's face
  backends, where the port does not read the weights itself;
- ``flops(arch, size)``: model FLOPs of one input (``size``: a detector's
  square canvas; None for an embedder, whose input size is its own);
- an embedder: ``encode(model, chips)`` (BGR chips → L2-normalised
  float32 rows) and ``dim(model)``;
- a face detector: ``detect_faces``; a person detector:
  ``detect_persons`` (the reference's calls, as ``reference/scrfd.py``
  and ``reference/yolov8.py`` define them).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROLES = ("detector", "embedder", "person")
# the detector and person sections named no family before there were
# others: such a section is the harness's first family of its role
FIRST = {"detector": "scrfd", "person": "yolov8"}


def family(kind: str):
    """The module ``families/<kind>.py``, loaded once."""
    name = f"{__name__}.{kind}"
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    path = os.path.join(HERE, f"{kind}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no model family {kind!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def kind_of(section: Dict, role: str) -> str:
    """The family a configuration section of ``role`` names."""
    if "kind" in section:
        return section["kind"]
    if role in FIRST:
        return FIRST[role]
    raise KeyError(f"the {role} section names no family (kind)")


def family_of(section: Dict, role: str):
    return family(kind_of(section, role))


def config_args(arch: Dict) -> Dict:
    """JSON lists → the tuples the frozen config dataclasses hold."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in arch.items()}
