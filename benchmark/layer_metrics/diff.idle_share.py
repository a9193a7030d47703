"""diff.idle_share: the share of the traced window in which nothing ran on
the card, in %."""

from yardstick import idle_pct


def read(ctx):
    return idle_pct(ctx)
