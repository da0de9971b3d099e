"""Video readers (``video/reader.py``, ``video/decodepool.py``): host wall
of the pre-scan's and the main pass's decode (``StepTimer`` stages
``prescan.decode`` and ``main.decode``), ms per source frame of the videos
after the traced one."""


def read(ctx):
    s = ctx["stages"]
    if "main.decode" not in s or not ctx["frames"]:
        return None
    return 1e3 * (s["main.decode"] + s.get("prescan.decode", 0.0)) \
        / ctx["frames"]
