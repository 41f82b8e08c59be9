"""K3's share of the hits layer's roofline (%): the yardstick's least time
of every traced request's ``search.locate_flat_device`` call (as
``hits_roofline``: enumerate, K3 and the SA resolve) over the device time
of the operations launched inside the port's ``awfm.backtrace`` spans
alone (``search.backtrace_resolve``: K3), from the trace. Nothing to read
in a count cell, or where the trace holds no such span."""


def read(ctx):
    layer = ctx.layers.get("hits")
    span = ((ctx.trace or {}).get("port") or {}).get("spans", {}).get("awfm.backtrace")
    if not layer or not span or span["device_s"] <= 0 or layer["least_ms"] <= 0:
        return None
    return 100.0 * layer["least_ms"] / (1e3 * span["device_s"])
