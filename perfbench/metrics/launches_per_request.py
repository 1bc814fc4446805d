"""Host-issued kernel and graph launches per request in the traced
window: the runtime's launch calls in the trace over the requests
dispatched in it."""


def read(run, name):
    tr = run.trace
    if tr is None:
        return None
    n = sum(1 for r in run.values.get("requests", [])
            if r["disp"] is not None and tr.t0 <= r["disp"] <= tr.t1)
    launches = tr.launches.get("kernel", 0) + tr.launches.get("graph", 0)
    if n == 0 or launches == 0:
        return None
    return launches / n
