"""Milliseconds a round outside the four timed buckets: the engine's own
host work (the scheduler's pops, wave grouping, weights, state closes,
the eval ring's flush) and the calls' launch and return, the round's
wall less client training, ingest, server round and eval."""


def read(rec):
    split = rec.get("split")
    if not split or not rec.get("rounds"):
        return None
    rest = rec["window_s"] - sum(split.values())
    return 1e3 * rest / rec["rounds"]
