"""Share of the traced window, in percent, of the card idle under a collection
of the interpreter (a runtime.gc span, any generation); from the program's
spans (``portbench/idle_split.py``)."""

from portbench.idle_split import share


def read(ctx):
    return share(ctx, "gc")
