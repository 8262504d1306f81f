"""setup_s: seconds from the start of the process to the first timed step: imports, the
CUDA context, the inputs, the system under test and its warm-up."""


def read(ctx):
    return ctx.setup_s
