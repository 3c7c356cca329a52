"""Checkpointing: pytree snapshots with step retention (:mod:`.io`)."""
