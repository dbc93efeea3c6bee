"""``setup_s``: seconds from the process's start to the window's start
(imports, CUDA start, loading or building the kernel library, the star
from the seed, a flatten done once, the warm-up of every query shape)."""


def read(ctx):
    return ctx.setup_s
