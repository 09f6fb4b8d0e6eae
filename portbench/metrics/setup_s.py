"""setup_s: process start to the first timed item (imports, CUDA start, the
kernels' load or build, the deployment's build, the cell's set-up and
warm-up), host clock."""


def read(ctx):
    return ctx.window["setup_s"]
