"""Device layer: the share of the traced slice's wall time in which no
operation ran on the card, in %."""


def read(run):
    if run.slice is None or run.slice.wall_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.wall_s)
