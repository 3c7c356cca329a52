"""Milliseconds a round in the server round, the engine's ``_aggregate``
call (the buffered step or the streaming finalize): host clock around each call, ended by a synchronize,
summed over the traced window and divided by its rounds."""


def read(rec):
    split = rec.get("split")
    if not split or not rec.get("rounds"):
        return None
    return 1e3 * split["server_round"] / rec["rounds"]
