"""setup_s (s, host clock): process start to the first timed batch —
imports, the kernels' build or load, weights, corpus, index and device
build, the query pool and the warm-up of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
