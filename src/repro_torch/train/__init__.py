"""The training substrate of the port — ``repro.train``'s checkpoint
manager, gradient compression and trainer.  ``elastic`` (resharding across
a changed device count) is not ported yet (ROADMAP Queue A 13.6)."""
