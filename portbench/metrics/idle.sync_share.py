"""Share of the traced window, in percent, of the card idle while the
dispatcher is in sync: waking on a finished group's event and reading its
results; from the program's spans (``portbench/idle_split.py``)."""

from portbench.idle_split import share


def read(ctx):
    return share(ctx, "sync")
