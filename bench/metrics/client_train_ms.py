"""Milliseconds a round in client training, the engine's ``_run_local`` /
``_train_wave`` calls: host clock around each call, ended by a synchronize,
summed over the traced window and divided by its rounds."""


def read(rec):
    split = rec.get("split")
    if not split or not rec.get("rounds"):
        return None
    return 1e3 * split["client_train"] / rec["rounds"]
