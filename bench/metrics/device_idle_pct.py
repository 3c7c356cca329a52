"""Share of the profiled sub-window in which no kernel, copy or memset
ran on the card (the union of their intervals, from the profiler's
trace)."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0.0 or t["device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
