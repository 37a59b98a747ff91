"""B1's share of its roofline in the traced span: the least time of its
launches (edbench/core/yardstick.py, counted per sector) over its device
time, in %."""


def read(ctx):
    return ctx.b1_roofline_pct()
