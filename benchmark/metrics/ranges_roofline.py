"""The ranges layer's share of its roofline (%): the yardstick's least
time of every traced request's ``search.ngram_ranges`` / ``search_ranges``
call over the calls' device time: the union of the device operations
launched inside them, from the trace. Nothing to read where
no ranges call was traced."""


def read(ctx):
    layer = ctx.layers.get("ranges")
    if not layer or layer["device_ms"] <= 0:
        return None
    return 100.0 * layer["least_ms"] / layer["device_ms"]
