"""The whole serving step's share of the card's peak for the view it
serves (``counts/topk.py``): 2 * items * features operations for each
answered request, over the window's seconds, in percent."""


def read(ctx):
    c = ctx.counters
    if not c.get("answers"):
        return None
    peak = ctx.peaks[ctx.counts("topk").view(c["score_mode"])["peak"]]
    ops = 2.0 * c["items"] * c["features"] * c["answers"]
    return ops / (c["window_s"] * peak) * 100.0
