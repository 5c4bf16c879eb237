"""Share of the traced window, in percent, of the card idle while the batcher's
dispatcher does its own host work (stage, issue, distribute): the host part
of a dispatch cycle exposed on the card; from the program's spans
(``portbench/idle_split.py``)."""

from portbench.idle_split import share


def read(ctx):
    return share(ctx, "dispatch_host")
