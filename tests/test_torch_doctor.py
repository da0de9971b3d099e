"""``python -m person_capture_tpu_torch.doctor`` against the JAX package's
doctor: every check with ``--device cpu``, with the same keys (and the same
values where they do not measure time)."""

import json
import time

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from person_capture_tpu import doctor as JD  # noqa: E402
from person_capture_tpu_torch import doctor as TD  # noqa: E402


def test_check_host_and_weights_match_jax():
    assert TD.check_host() == JD.check_host()
    w = TD.check_weights()
    assert w == JD.check_weights() and w["ok"]


@pytest.mark.parametrize("spec", ["auto", "explicit", "off", "unwritable"])
def test_check_cache(monkeypatch, tmp_path, spec):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    arg = {"auto": "auto", "explicit": str(tmp_path / "explicit"),
           "off": "off", "unwritable": str(blocker / "sub")}[spec]
    got, want = TD.check_cache(arg), JD.check_cache(arg)
    assert set(got) == set(want)
    assert (got["writable"], got["entries"]) == \
        (want["writable"], want["entries"])
    if spec == "auto":
        assert got["dir"] == str(tmp_path / "xdg" / "person_capture_tpu_torch")
        assert got["writable"]
    elif spec != "unwritable":
        assert got["dir"] == want["dir"]
    else:
        assert not got["writable"] and got.get("error")


@pytest.mark.parametrize("state", ["missing", "running", "stale", "exited"])
def test_check_sweep_matches_jax(tmp_path, state):
    now = time.time()
    if state != "missing":
        (tmp_path / "sweep_status.json").write_text(json.dumps({
            "video": "v.mp4", "progress": 0.4, "processed": 2, "failed": 0,
            "phase": "exited" if state == "exited" else "running",
            "updated": now - (3600 if state in ("stale", "exited") else 0)}))
        (tmp_path / "sweep_summary.json").write_text(json.dumps(
            {"corpus": 5, "processed": 2, "failed": 0, "resumed": 1,
             "failed_backend": 0, "failed_video": 0, "results": []}))
    got, want = TD.check_sweep(str(tmp_path)), JD.check_sweep(str(tmp_path))
    for d in (got, want):
        d.pop("age_s", None)
    assert got == want
    assert got["found"] == (state != "missing")
    if state != "missing":
        assert got["alive"] == (state != "stale")


def test_check_decode_keys():
    got = TD.check_decode(seconds=1.0, width=320, height=240)
    want = JD.check_decode(seconds=1.0, width=320, height=240)
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] >= 24 and got["decode_fps"] > 0


def test_check_device_on_the_cpu():
    got = TD.check_device(probe_budget_s=120.0, reps=2, platform="cpu")
    want = JD.check_device(probe_budget_s=120.0, reps=2, platform="cpu")
    assert got["ok"] and want["ok"], (got, want)
    assert set(got) == set(want)
    assert got["platform"] == want["platform"] == "cpu"
    assert got["upload_mb_s"] > 0 and got["download_mb_s"] > 0
    assert got["mainpass_link_ceiling_x"] > 0


def test_main_json_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    argv = ["--json", "--skip-decode", "--device", "cpu"]
    assert TD.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert JD.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"host", "weights", "cache", "device",
                                     "ok"}
    assert got["ok"] and got["device"]["platform"] == "cpu"
    assert set(got["device"]) == set(want["device"])
