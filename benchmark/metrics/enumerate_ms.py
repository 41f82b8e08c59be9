"""Enumerate's device milliseconds a call: the union of the device
operations launched inside the port's ``awfm.enumerate`` spans
(``search.enumerate_flat``, one a locate request), from the trace, over
the spans opened in the window. Nothing to read in a count cell, or where
the trace holds no such span."""


def read(ctx):
    span = ((ctx.trace or {}).get("port") or {}).get("spans", {}).get("awfm.enumerate")
    if not span or span["calls"] <= 0 or span["device_s"] <= 0:
        return None
    return 1e3 * span["device_s"] / span["calls"]
