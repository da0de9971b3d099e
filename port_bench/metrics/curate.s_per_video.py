"""The curator (``curator/core.py`` through ``Engine._run_curator``):
seconds of the benchmark's span around the engine's curator call, mean
over the videos after the traced one."""


def read(ctx):
    spans = ctx["curate_s"]
    return sum(spans) / len(spans) if spans else None
