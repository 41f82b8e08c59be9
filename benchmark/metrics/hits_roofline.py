"""The hits layer's share of its roofline (%): the yardstick's least time
of every traced request's ``search.locate_flat_device`` call (enumerate,
K3 and the SA resolve) over the calls' device time: the union of the
device operations launched inside them, from the trace.
Nothing to read in a count cell."""


def read(ctx):
    layer = ctx.layers.get("hits")
    if not layer or layer["device_ms"] <= 0 or layer["least_ms"] <= 0:
        return None
    return 100.0 * layer["least_ms"] / layer["device_ms"]
