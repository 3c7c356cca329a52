"""Milliseconds a round in the codec and the channel's ingest, the
engine's ``_enqueue_upload``, ``_payload_rows`` and ``_ingest_wave``
calls: host clock around each call, ended by a synchronize,
summed over the traced window and divided by its rounds."""


def read(rec):
    split = rec.get("split")
    if not split or not rec.get("rounds"):
        return None
    return 1e3 * split["server_ingest"] / rec["rounds"]
