"""Share of the traced window, in percent, of the card idle while the
dispatcher waits on an empty queue: every request is in the front end, the
event loop or the clients; from the program's spans
(``portbench/idle_split.py``)."""

from portbench.idle_split import share


def read(ctx):
    return share(ctx, "empty_queue")
