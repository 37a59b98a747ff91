"""Share of the traced span in which no kernel ran on the card, in %."""


def read(ctx):
    return ctx.idle_pct()
