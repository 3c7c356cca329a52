"""The server's aggregation against its roofline: the logical bytes of
the fold and round calls in the profiled sub-window (each input read
once, each output written once, at the wire's width:
``bench.measure.agg_bytes``) over the card's 3.35 TB/s, as a share of
the device seconds of every kernel launched inside those calls.  A
kernel belongs to a call when the CUDA API call that launched it lies
between the call's two synchronizes (``bench.tracing``), never by the
kernel's name, so the share reads the same work whatever implements
it."""

PEAK_BYTES = 3.35e12


def read(rec):
    t = rec.get("trace")
    if not t or not t["server_kernel_s"]:
        return None
    nbytes = sum(rec["server_bytes"][c] * n
                 for c, n in t["server_calls"].items())
    return 100.0 * nbytes / PEAK_BYTES / t["server_kernel_s"]
