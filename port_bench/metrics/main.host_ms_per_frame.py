"""The main pass's host side (``pipeline/mainpass.py``): submit, replay
and compose-and-save (``main.submit`` + ``main.host_replay`` +
``main.compose_save``), ms per source frame of the videos after the
traced one."""


def read(ctx):
    s = ctx["stages"]
    if "main.submit" not in s or not ctx["frames"]:
        return None
    return 1e3 * (s["main.submit"] + s.get("main.host_replay", 0.0)
                  + s.get("main.compose_save", 0.0)) / ctx["frames"]
