"""Seconds per solve: the window's span, first solve's start to last
solve's end (answers read back), over its solves."""


def read(ctx):
    return ctx.seconds_per_solve()
