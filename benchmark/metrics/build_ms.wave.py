"""build_ms.wave: mean ms of ``solver/problem.py build_problem`` per wave (the
harness's span around the call)."""


def read(ctx):
    return ctx.mean("build_problem")
