"""The harness, its model families and what it loads of the port import
neither JAX nor the JAX package: top-level module names compared
whole."""

import subprocess
import sys

from .conftest import ROOT

PROBE = """
import sys
import port_bench.run, port_bench.check, port_bench.calibrate
import port_bench.flops, port_bench.trace, port_bench.probe
import port_bench.reference.pipeline
import os
from port_bench.families import HERE, family
for name in sorted(os.listdir(HERE)):
    if name.endswith(".py") and not name.startswith("_"):
        family(name[:-3])
from person_capture_tpu_torch import main as M
from person_capture_tpu_torch.pipeline import engine, backends, mainpass
from person_capture_tpu_torch.models import bridge
from person_capture_tpu_torch.curator import core
from port_bench.run import forbidden_modules
print(",".join(forbidden_modules()) or "none")
"""


def test_no_jax_in_the_harness():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_whole_names(monkeypatch):
    """``person_capture_tpu_torch`` is not ``person_capture_tpu``; a
    submodule of ``jax`` is ``jax``."""
    from port_bench.run import forbidden_modules

    clean = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in ("jax", "jaxlib", "flax",
                                        "person_capture_tpu")}
    monkeypatch.setattr(sys, "modules", dict(clean))
    sys.modules["person_capture_tpu_torch_probe"] = sys
    assert forbidden_modules() == []
    sys.modules["jax.numpy"] = sys
    sys.modules["person_capture_tpu.main"] = sys
    assert forbidden_modules() == ["jax", "person_capture_tpu"]
