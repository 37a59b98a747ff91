"""Mean seconds of the greens_functions phase (SolveResult.timings)
over the window's solves."""


def read(ctx):
    return ctx.phase_mean("greens_functions")
