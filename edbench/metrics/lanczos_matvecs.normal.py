"""Mean Lanczos sweep matvecs a solve (DiagResult.lanczos_stats) over
the window's solves."""


def read(ctx):
    return ctx.matvecs_mean()
