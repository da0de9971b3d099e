"""Self-update manager (copied from ``person_capture_tpu/updater.py``).

Headless rebuild of the reference's UpdateManager (person_capture/
updater.py:660): prefer a git fast-forward when the install is a clean git
checkout; otherwise stage a release ZIP that is applied on next start,
preserving user data paths; re-run dependency install only when the
requirements file changed. GUI hooks (menu/QObject signals) are replaced by
plain callables; the apply-on-next-start flag file semantics are kept.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import zipfile
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

PRESERVE_DIRS = ("output", "prescan_cache", "trt_cache", ".ultralytics")
STAGE_FLAG = ".pc_staged_update.json"
INSTALLED_META = ".pc_installed_release.json"


def installed_release_tag(repo_dir: str) -> str:
    """Tag of the last release applied through the staged-ZIP path (empty
    when none was). Non-git installs have no other durable version marker —
    __version__ never matches release tag formats, so check() would report
    an already-applied release as available forever without this."""
    try:
        with open(os.path.join(repo_dir, INSTALLED_META)) as fh:
            return str(json.load(fh).get("tag", ""))
    except (OSError, json.JSONDecodeError, AttributeError):
        return ""


def _norm_tag(tag: str) -> str:
    return tag.strip().lstrip("vV")


def current_version(repo_dir: str) -> str:
    """Version string: git describe/commit when available, else package."""
    head = _git(repo_dir, "rev-parse", "--short", "HEAD")
    if head:
        dirty = _git(repo_dir, "status", "--porcelain")
        return head + ("+dirty" if dirty else "")
    try:
        from . import __version__
        return __version__
    except ImportError:
        return "unknown"


def _git(repo_dir: str, *args: str) -> Optional[str]:
    try:
        cp = subprocess.run(["git", "-C", repo_dir, *args],
                            capture_output=True, text=True, timeout=60,
                            check=False)
        if cp.returncode != 0:
            return None
        return cp.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def git_update_available(repo_dir: str, remote: str = "origin",
                         branch: str = "") -> Tuple[bool, str]:
    """Fetch and compare HEAD vs upstream. Returns (available, detail)."""
    if _git(repo_dir, "rev-parse", "--git-dir") is None:
        return False, "not_a_git_checkout"
    if _git(repo_dir, "fetch", remote) is None:
        return False, "fetch_failed"
    upstream = f"{remote}/{branch}" if branch else "@{u}"
    behind = _git(repo_dir, "rev-list", "--count", f"HEAD..{upstream}")
    if behind is None:
        return False, "no_upstream"
    return int(behind) > 0, f"behind_by_{behind}"


def git_fast_forward(repo_dir: str, remote: str = "origin",
                     branch: str = "") -> Tuple[bool, str]:
    """Fast-forward only; refuses on local modifications (stash-safe check,
    reference: updater.py:243-292)."""
    dirty = _git(repo_dir, "status", "--porcelain")
    if dirty:
        return False, "working_tree_dirty"
    target = f"{remote}/{branch}" if branch else "@{u}"
    out = _git(repo_dir, "merge", "--ff-only", target)
    if out is None:
        return False, "ff_merge_failed"
    return True, out.splitlines()[0] if out else "up_to_date"


# ---------------------------------------------------------------------------
# staged ZIP updates
# ---------------------------------------------------------------------------

def stage_zip_update(repo_dir: str, zip_path: str,
                     version: str = "") -> Tuple[bool, str]:
    """Extract a release ZIP into a staging dir + write the apply flag; the
    update is applied by :func:`apply_staged_update` on next start."""
    if not os.path.isfile(zip_path):
        return False, "zip_missing"
    stage_dir = os.path.join(repo_dir, ".pc_update_stage")
    if os.path.isdir(stage_dir):
        shutil.rmtree(stage_dir, ignore_errors=True)
    os.makedirs(stage_dir, exist_ok=True)
    try:
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(stage_dir)
    except (OSError, zipfile.BadZipFile) as e:
        return False, f"extract_failed:{e}"
    # single top-level folder (GitHub archive layout) → use it as the root
    entries = os.listdir(stage_dir)
    root = stage_dir
    if len(entries) == 1 and os.path.isdir(os.path.join(stage_dir, entries[0])):
        root = os.path.join(stage_dir, entries[0])
    flag = {"root": root, "version": version}
    with open(os.path.join(repo_dir, STAGE_FLAG), "w") as fh:
        json.dump(flag, fh)
    return True, root


def staged_update_pending(repo_dir: str) -> bool:
    return os.path.isfile(os.path.join(repo_dir, STAGE_FLAG))


def apply_staged_update(repo_dir: str) -> Tuple[bool, str]:
    """Copy the staged tree over the install, preserving user data dirs,
    then clear the flag (reference: updater.py:510-594)."""
    flag_path = os.path.join(repo_dir, STAGE_FLAG)
    if not os.path.isfile(flag_path):
        return False, "no_staged_update"
    try:
        with open(flag_path) as fh:
            flag = json.load(fh)
        root = flag["root"]
    except (OSError, json.JSONDecodeError, KeyError) as e:
        os.remove(flag_path)
        return False, f"bad_flag:{e}"
    if not os.path.isdir(root):
        os.remove(flag_path)
        return False, "stage_dir_missing"

    old_requirements = _read(os.path.join(repo_dir, "requirements.txt"))
    name = ""
    try:
        for name in os.listdir(root):
            if name in PRESERVE_DIRS or name == STAGE_FLAG:
                continue
            src = os.path.join(root, name)
            dst = os.path.join(repo_dir, name)
            if os.path.isdir(src):
                if os.path.isfile(dst):    # file → dir in the new release
                    os.remove(dst)
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                if os.path.isdir(dst):     # dir → file in the new release
                    shutil.rmtree(dst)
                shutil.copy2(src, dst)
    except (OSError, shutil.Error) as e:
        # report, never raise (updater contract) — and clear the flag so a
        # deterministic copy failure cannot become a crash-on-every-start
        # loop; the install may be half-applied, which the detail surfaces
        try:
            os.remove(flag_path)
        except OSError:
            pass
        return False, f"apply_failed:{name}:{type(e).__name__}:{e}"
    new_requirements = _read(os.path.join(repo_dir, "requirements.txt"))
    version = str(flag.get("version") or "")
    if version:
        try:
            with open(os.path.join(repo_dir, INSTALLED_META), "w") as fh:
                json.dump({"tag": version}, fh)
        except OSError:
            pass
    os.remove(flag_path)
    shutil.rmtree(os.path.join(repo_dir, ".pc_update_stage"),
                  ignore_errors=True)
    needs_deps = (old_requirements != new_requirements
                  and new_requirements is not None)
    return True, "deps_changed" if needs_deps else "applied"


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return None


# ---------------------------------------------------------------------------
# GitHub release check / download (reference: updater.py:209-242, 348-390)
# ---------------------------------------------------------------------------

def _default_fetch_json(url: str, timeout: float = 20.0):
    import urllib.request

    req = urllib.request.Request(url, headers={
        "Accept": "application/vnd.github+json",
        "User-Agent": "person-capture-tpu-updater"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def github_latest_release(repo_slug: str, fetch_json=None) -> Optional[dict]:
    """Latest release metadata for ``owner/repo``; None on any failure.
    ``fetch_json`` is injectable so offline installs/tests can stub it."""
    fetch_json = fetch_json or _default_fetch_json
    try:
        data = fetch_json(
            f"https://api.github.com/repos/{repo_slug}/releases/latest")
    except Exception:
        # fall back to the branch ZIP (repos without releases)
        return None
    if not isinstance(data, dict):
        return None
    return {
        "tag": data.get("tag_name") or "",
        "zip_url": data.get("zipball_url") or "",
        "name": data.get("name") or "",
    }


def download_zip(url: str, dest_path: str, opener=None) -> Tuple[bool, str]:
    """Download a release ZIP. ``opener(url) -> bytes`` is injectable;
    local paths / file: URLs are read directly (offline tests)."""
    try:
        if opener is not None:
            data = opener(url)
        elif os.path.isfile(url):
            data = _read_bytes(url)
        elif url.startswith("file://"):
            data = _read_bytes(url[len("file://"):])
        else:
            import urllib.request

            req = urllib.request.Request(
                url, headers={"User-Agent": "person-capture-tpu-updater"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                data = resp.read()
        if not data:
            return False, "empty_download"
        with open(dest_path, "wb") as fh:
            fh.write(data)
        return True, dest_path
    except Exception as e:  # noqa: BLE001 — updater reports, never raises
        return False, f"download_failed:{type(e).__name__}:{e}"


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# dependency install + restart handshake (reference: updater.py:209-242,
# 595-652)
# ---------------------------------------------------------------------------

def pip_install_cmd(repo_dir: str) -> List[str]:
    import sys

    return [sys.executable, "-m", "pip", "install", "-r",
            os.path.join(repo_dir, "requirements.txt")]


def pip_install_requirements(repo_dir: str, runner=None) -> Tuple[bool, str]:
    """Run ``pip install -r requirements.txt`` (only called when the apply
    step reported deps_changed). ``runner`` is injectable for tests."""
    cmd = pip_install_cmd(repo_dir)
    if not os.path.isfile(cmd[-1]):
        return True, "no_requirements_file"
    runner = runner or (lambda c: subprocess.run(
        c, capture_output=True, text=True, timeout=1800, check=False))
    try:
        cp = runner(cmd)
        rc = getattr(cp, "returncode", 0)
        if rc != 0:
            tail = (getattr(cp, "stderr", "") or "")[-400:]
            return False, f"pip_failed_rc{rc}:{tail}"
        return True, "deps_installed"
    except Exception as e:  # noqa: BLE001
        return False, f"pip_error:{type(e).__name__}:{e}"


RESTART_ENV = "PC_UPDATER_RESTARTED"


def build_restart_argv() -> List[str]:
    import sys

    return [sys.executable] + sys.argv


def restart_process(execv=None) -> Optional[str]:
    """Replace the process with a fresh interpreter after an applied update
    (reference self-restart, updater.py:595-652). The RESTART_ENV handshake
    prevents restart loops: a process that was itself started by the
    updater refuses to restart again. Returns an error string instead of
    exec'ing when refused."""
    if os.environ.get(RESTART_ENV):
        return "already_restarted_once"
    os.environ[RESTART_ENV] = "1"
    argv = build_restart_argv()
    (execv or os.execv)(argv[0], argv)
    return None  # pragma: no cover — execv does not return


@dataclass
class UpdateManager:
    """Check/perform updates with plain callbacks (GUI-free).

    Strategy mirrors the reference UpdateManager (updater.py:660): a clean
    git checkout fast-forwards in place; otherwise the latest GitHub
    release ZIP is downloaded and staged for apply-on-next-start, with
    ``pip install -r`` re-run only when requirements changed, then a
    restart handshake."""

    repo_dir: str
    remote: str = "origin"
    branch: str = ""
    github_repo: str = ""           # "owner/repo" for the ZIP path
    status: Callable[[str], None] = lambda msg: None
    fetch_json: Optional[Callable] = None   # injectable (offline/test)
    zip_opener: Optional[Callable] = None
    pip_runner: Optional[Callable] = None

    def version(self) -> str:
        return current_version(self.repo_dir)

    def check(self) -> Tuple[bool, str]:
        self.status("checking for updates")
        ok, detail = git_update_available(self.repo_dir, self.remote,
                                          self.branch)
        if detail not in ("not_a_git_checkout", "fetch_failed",
                          "no_upstream"):
            return ok, detail
        if not self.github_repo:
            return ok, detail
        rel = github_latest_release(self.github_repo, self.fetch_json)
        if rel is None or not rel["zip_url"]:
            return False, f"{detail};github_unavailable"
        tag = _norm_tag(rel["tag"])
        installed = (_norm_tag(installed_release_tag(self.repo_dir))
                     or _norm_tag(self.version()))
        available = bool(tag) and tag != installed
        return available, f"github:{rel['tag'] or 'unknown'}"

    def perform(self) -> Tuple[bool, str]:
        self.status("updating")
        ok, detail = git_fast_forward(self.repo_dir, self.remote, self.branch)
        if ok or not self.github_repo:
            self.status(f"update {'ok' if ok else 'failed'}: {detail}")
            return ok, detail
        rel = github_latest_release(self.github_repo, self.fetch_json)
        if rel is None or not rel["zip_url"]:
            return False, f"{detail};github_unavailable"
        zpath = os.path.join(self.repo_dir, ".pc_update.zip")
        ok, got = download_zip(rel["zip_url"], zpath, self.zip_opener)
        if not ok:
            return False, got
        ok, staged = stage_zip_update(self.repo_dir, zpath,
                                      version=rel["tag"])
        self.status(f"staged {rel['tag']}: {staged}" if ok
                    else f"stage failed: {staged}")
        return ok, ("staged_for_next_start" if ok else staged)

    def apply_on_start(self, auto_deps: bool = True) -> Tuple[bool, str]:
        """Call early at process start: applies a pending staged update and
        re-installs dependencies when requirements changed. Returns
        (restart_recommended, detail)."""
        if not staged_update_pending(self.repo_dir):
            return False, "no_staged_update"
        ok, detail = apply_staged_update(self.repo_dir)
        if not ok:
            return False, detail
        if detail == "deps_changed" and auto_deps:
            dok, ddetail = pip_install_requirements(self.repo_dir,
                                                    self.pip_runner)
            self.status(f"dependencies: {ddetail}")
            if dok:
                detail = f"{detail};{ddetail}"
            else:
                # the code tree was replaced but its dependencies were NOT
                # installed: surface a machine-readable marker so callers
                # can warn instead of restarting into a broken install
                detail = f"{detail};DEPS_FAILED:{ddetail}"
                self.status("update applied but dependency install FAILED; "
                            "run pip install -r requirements.txt manually")
                return True, detail
        self.status("update applied; restart recommended")
        return True, detail
