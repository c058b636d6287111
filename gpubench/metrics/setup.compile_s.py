"""``setup.compile_s``: host seconds of ``plan(...).compile()``, ending
in a device synchronise (the benchmark's span around the call; it holds
the uploads and, under ``use_kernel``, the tile build)."""


def read(run):
    return run.spans.get("plan_compile")
