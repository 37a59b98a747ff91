"""Mean seconds of the diagonalization phase (SolveResult.timings, the
card synchronized at each edge) over the window's solves."""


def read(ctx):
    return ctx.phase_mean("diagonalization")
