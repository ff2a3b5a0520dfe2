"""Process start to the first timed call: imports, weights, kernel loading
(and the nvcc build on a checkout's first run), warm-up."""

UNIT = "s"


def read(ctx):
    return ctx["outcome"]["setup_s"]
