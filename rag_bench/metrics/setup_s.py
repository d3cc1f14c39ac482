"""Set-up: process start to the window's opening (the origin the first
arrival is due from): build-cache load, weights, corpus, index, engine and
its graphs, warm-up."""


def read(ctx):
    return ctx.setup_s
