"""The share of the traced window (%) in which the device is idle while
the host is inside one of the port's ``awfm.*`` spans: the idle time
that the port's own host work holds (its checks, launches and torch
dispatch), as against the harness's. At most ``device_idle``. Nothing to
read where the trace holds no device operation or no such span."""


def read(ctx):
    t = ctx.trace
    port = (t or {}).get("port")
    if not port or not port["spans"] or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * port["idle_s"] / t["window_s"]
