"""Milliseconds a round in the eval, the engine's ``_eval_and_record`` /
``_eval_round`` calls: host clock around each call, ended by a synchronize,
summed over the traced window and divided by its rounds."""


def read(rec):
    split = rec.get("split")
    if not split or not rec.get("rounds"):
        return None
    return 1e3 * split["eval"] / rec["rounds"]
