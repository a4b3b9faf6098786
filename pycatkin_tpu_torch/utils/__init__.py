"""Host-side utilities: the event log and counted host syncs
(:mod:`.profiling`), transport retry (:mod:`.retry`) and the wire form of
a mechanism plus result and JSON-lines files (:mod:`.io`)."""
