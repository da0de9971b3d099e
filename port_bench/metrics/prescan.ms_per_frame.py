"""The pre-scan (``pipeline/prescan.py``): host wall waiting on its device
batches and replaying them (``prescan.device_fetch`` +
``prescan.host_replay``), ms per source frame of the videos after
the traced one."""


def read(ctx):
    s = ctx["stages"]
    if "prescan.host_replay" not in s or not ctx["frames"]:
        return None
    return 1e3 * (s.get("prescan.device_fetch", 0.0)
                  + s["prescan.host_replay"]) / ctx["frames"]
