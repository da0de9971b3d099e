"""The port's self-update manager (``updater.py``): the JAX package's cases
on the port's module, and its decisions held equal to the JAX functions on
the same inputs (tags, versions, staged trees and zips, pip and restart
commands). The network and subprocess hooks are stubbed: nothing here
touches the network."""

import os
import subprocess
import zipfile

import pytest

from person_capture_tpu import updater as J
from person_capture_tpu_torch import updater as U

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_zip(tmp_path, files, name="update.zip"):
    zp = str(tmp_path / name)
    with zipfile.ZipFile(zp, "w") as zf:
        for member, content in files.items():
            zf.writestr(member, content)
    return zp


def _make_release_zip(tmp_path, reqs="new==2.0\n"):
    return _make_zip(tmp_path, {
        "proj-1.2.3/requirements.txt": reqs,
        "proj-1.2.3/person_capture_tpu_torch/__init__.py": "# v1.2.3\n"},
        name="rel.zip")


def _tree(root):
    """{relative path: file content} of every file under ``root``."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_current_version_in_repo():
    v = U.current_version(REPO)
    assert v and v != "unknown"


def test_stage_and_apply_zip(tmp_path):
    repo = tmp_path / "install"
    repo.mkdir()
    (repo / "keepme.txt").write_text("old")
    (repo / "output").mkdir()
    (repo / "output" / "data.csv").write_text("user data")
    zp = _make_zip(tmp_path, {
        "release-1.2/keepme.txt": "new",
        "release-1.2/newfile.py": "print('hi')",
        "release-1.2/output/should_not_overwrite.txt": "bad",
    })
    ok, _root = U.stage_zip_update(str(repo), zp, version="1.2")
    assert ok
    assert U.staged_update_pending(str(repo))
    ok, detail = U.apply_staged_update(str(repo))
    assert ok, detail
    assert (repo / "keepme.txt").read_text() == "new"
    assert (repo / "newfile.py").exists()
    # user data preserved
    assert (repo / "output" / "data.csv").read_text() == "user data"
    assert not (repo / "output" / "should_not_overwrite.txt").exists()
    assert not U.staged_update_pending(str(repo))


def test_apply_without_stage(tmp_path):
    ok, detail = U.apply_staged_update(str(tmp_path))
    assert not ok and detail == "no_staged_update"


def test_stage_missing_zip(tmp_path):
    ok, detail = U.stage_zip_update(str(tmp_path), str(tmp_path / "nope.zip"))
    assert not ok and detail == "zip_missing"


def test_requirements_change_detection(tmp_path):
    repo = tmp_path / "install"
    repo.mkdir()
    (repo / "requirements.txt").write_text("torch==2.0\n")
    zp = _make_zip(tmp_path, {"r/requirements.txt": "torch==2.1\n"})
    U.stage_zip_update(str(repo), zp)
    ok, detail = U.apply_staged_update(str(repo))
    assert ok and detail == "deps_changed"


def test_git_update_not_a_checkout(tmp_path):
    avail, detail = U.git_update_available(str(tmp_path))
    assert not avail and detail == "not_a_git_checkout"


def _dirty_checkout(repo):
    repo.mkdir()
    subprocess.run(["git", "init", "-q", str(repo)], check=True)
    (repo / "a.txt").write_text("x")
    subprocess.run(["git", "-C", str(repo), "add", "."], check=True)
    subprocess.run(["git", "-C", str(repo), "-c", "user.email=t@t",
                    "-c", "user.name=t", "commit", "-qm", "init"], check=True)
    (repo / "a.txt").write_text("dirty")


def test_git_ff_refuses_dirty(tmp_path):
    repo = tmp_path / "g"
    _dirty_checkout(repo)
    ok, detail = U.git_fast_forward(str(repo))
    assert not ok and detail == "working_tree_dirty"


def test_github_zip_check_download_stage_apply_deps(tmp_path):
    """Offline GitHub-path end to end: release check (stubbed fetcher) →
    ZIP download (local path) → stage → apply detects a requirements change
    → pip command issued (stubbed runner)."""
    repo = tmp_path / "install"
    repo.mkdir()
    (repo / "requirements.txt").write_text("old==1.0\n")
    (repo / "output").mkdir()
    (repo / "output" / "keep.txt").write_text("user data")
    zpath = _make_release_zip(tmp_path)
    calls = {}
    mgr = U.UpdateManager(
        repo_dir=str(repo), github_repo="owner/proj",
        fetch_json=lambda url: {"tag_name": "v1.2.3",
                                "zipball_url": zpath, "name": "r"},
        pip_runner=lambda cmd: calls.setdefault("pip", cmd) or
        type("R", (), {"returncode": 0, "stderr": ""})())
    avail, detail = mgr.check()
    assert avail and detail == "github:v1.2.3"
    ok, detail = mgr.perform()
    assert ok and detail == "staged_for_next_start"
    assert U.staged_update_pending(str(repo))
    restart, detail = mgr.apply_on_start(auto_deps=True)
    assert restart
    assert detail.startswith("deps_changed")
    assert "pip" in calls and calls["pip"][-1].endswith("requirements.txt")
    assert (repo / "output" / "keep.txt").read_text() == "user data"
    assert (repo / "requirements.txt").read_text() == "new==2.0\n"
    assert not U.staged_update_pending(str(repo))


def test_github_zip_same_requirements_no_pip(tmp_path):
    repo = tmp_path / "install"
    repo.mkdir()
    (repo / "requirements.txt").write_text("same==1.0\n")
    zpath = _make_release_zip(tmp_path, reqs="same==1.0\n")
    ok, _ = U.download_zip(zpath, str(repo / "dl.zip"))
    assert ok
    ok, _root = U.stage_zip_update(str(repo), str(repo / "dl.zip"), "v9")
    assert ok
    ok, detail = U.apply_staged_update(str(repo))
    assert ok and detail == "applied"


def test_restart_handshake_prevents_loops(monkeypatch):
    monkeypatch.delenv(U.RESTART_ENV, raising=False)
    execd = {}

    def fake_execv(exe, argv):
        execd["argv"] = argv

    assert U.restart_process(execv=fake_execv) is None
    assert execd["argv"][0] == U.build_restart_argv()[0]
    # second attempt in the restarted process is refused
    assert U.restart_process(execv=fake_execv) == "already_restarted_once"


def test_github_check_converges_after_apply(tmp_path):
    """An applied release is recorded and no longer reported available."""
    repo = tmp_path / "install"
    repo.mkdir()
    rel = {"tag_name": "v1.2.3",
           "zipball_url": _make_release_zip(tmp_path), "name": "r"}
    mgr = U.UpdateManager(repo_dir=str(repo), github_repo="o/r",
                          fetch_json=lambda url: rel)
    avail, detail = mgr.check()
    assert avail and detail == "github:v1.2.3"
    ok, _ = mgr.perform()
    assert ok
    ok, _ = U.apply_staged_update(str(repo))
    assert ok
    assert U.installed_release_tag(str(repo)) == "v1.2.3"
    avail, detail = mgr.check()
    assert not avail and detail == "github:v1.2.3"
    rel["tag_name"] = "v1.3.0"
    avail, _ = mgr.check()
    assert avail


def test_apply_handles_dir_over_file_collision(tmp_path):
    repo = tmp_path / "install"
    repo.mkdir()
    (repo / "plugins").write_text("was a file")
    (repo / "conf").mkdir()
    (repo / "conf" / "x").write_text("1")
    zpath = _make_zip(tmp_path, {"proj/plugins/mod.py": "# now a dir\n",
                                 "proj/conf": "now a file"}, name="rel2.zip")
    ok, _ = U.stage_zip_update(str(repo), zpath, "v2")
    assert ok
    ok, detail = U.apply_staged_update(str(repo))
    assert ok, detail
    assert (repo / "plugins" / "mod.py").is_file()
    assert (repo / "conf").is_file()
    assert not U.staged_update_pending(str(repo))


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("tag", ["v1.2.3", " V2.0 ", "1.0", "vv3", "", "x"])
def test_norm_tag_matches_jax(tag):
    assert U._norm_tag(tag) == J._norm_tag(tag)


def test_current_version_matches_jax(tmp_path):
    repo = tmp_path / "g"
    _dirty_checkout(repo)
    for d in (REPO, str(repo), str(tmp_path)):
        assert U.current_version(d) == J.current_version(d), d


def test_commands_match_jax(tmp_path):
    assert U.pip_install_cmd(str(tmp_path)) == J.pip_install_cmd(
        str(tmp_path))
    assert U.build_restart_argv() == J.build_restart_argv()


def _install(root, requirements):
    root.mkdir()
    (root / "keepme.txt").write_text("old")
    (root / "plugins").write_text("was a file")
    (root / "output").mkdir()
    (root / "output" / "data.csv").write_text("user data")
    if requirements is not None:
        (root / "requirements.txt").write_text(requirements)


@pytest.mark.parametrize("members,requirements", [
    ({"rel/keepme.txt": "new", "rel/plugins/mod.py": "# dir\n",
      "rel/output/x.txt": "bad", "rel/requirements.txt": "a==2\n"},
     "a==1\n"),
    ({"rel/requirements.txt": "a==1\n", "rel/new.py": "x"}, "a==1\n"),
    ({"keepme.txt": "flat", "other.txt": "two top-level entries"}, None),
    ({}, None),
], ids=["deps_changed", "applied", "flat_zip", "empty_zip"])
def test_stage_and_apply_match_jax(tmp_path, members, requirements):
    """The same zip staged and applied on two identical installs by both
    packages: the same results, flags and resulting trees."""
    zp = _make_zip(tmp_path, members)
    results, trees = {}, {}
    for name, mod in (("jax", J), ("port", U)):
        root = tmp_path / name
        _install(root, requirements)
        ok, where = mod.stage_zip_update(str(root), zp, version="v7")
        pending = mod.staged_update_pending(str(root))
        applied = mod.apply_staged_update(str(root))
        results[name] = (ok, os.path.relpath(where, str(root)) if ok
                         else where, pending, applied,
                         mod.installed_release_tag(str(root)))
        trees[name] = _tree(str(root))
    assert results["port"] == results["jax"]
    assert trees["port"] == trees["jax"]


def test_bad_zip_and_missing_stage_match_jax(tmp_path):
    bad = tmp_path / "bad.zip"
    bad.write_bytes(b"not a zip")
    for zp in (str(bad), str(tmp_path / "nope.zip")):
        got = U.stage_zip_update(str(tmp_path), zp)
        want = J.stage_zip_update(str(tmp_path), zp)
        assert got[0] == want[0] and got[1].split(":")[0] == \
            want[1].split(":")[0]
    assert U.apply_staged_update(str(tmp_path)) == \
        J.apply_staged_update(str(tmp_path))
