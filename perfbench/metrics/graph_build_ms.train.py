"""Mean device ms of the program's graph build (`build_tile_graph`) per
batch, on each of one epoch's batches of the pool, timed with CUDA events
by the benchmark's own calls outside the window."""


def read(ctx):
    return ctx.graph_build_ms()
