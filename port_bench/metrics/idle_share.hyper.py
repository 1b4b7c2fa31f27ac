"""Device: the share of the traced hyper rounds' window in which no
operation ran on the card, 1 − (union of the device operations' intervals)
/ window, in %."""


def read(tv):
    if not tv or tv.window_s() <= 0 or not tv.ops:
        return None
    return 100.0 * (1.0 - tv.busy_s() / tv.window_s())
