"""The combined face+person step (``pipeline/backends.py``) as the main
pass waits on it (``main.device_fetch``), ms per source frame of the
videos after the traced one."""


def read(ctx):
    s = ctx["stages"]
    if "main.device_fetch" not in s or not ctx["frames"]:
        return None
    return 1e3 * s["main.device_fetch"] / ctx["frames"]
