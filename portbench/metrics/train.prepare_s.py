"""Seconds of host preparation of set-up's first build: list building
and upload (``build_bucketed_lists``, ``_upload_buckets``), the program's
own ``timings["lists_s"]`` from ``train_als``."""


def read(ctx):
    return ctx.counters.get("prepare_s")
