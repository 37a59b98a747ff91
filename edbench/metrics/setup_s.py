"""Set-up seconds: from the start of the run through imports, CUDA
initialization, the program's libraries, ed_init_solver and the warm-up
solve."""


def read(ctx):
    return ctx.setup_s
