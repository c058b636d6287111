"""``gteps.bits``: ``gteps`` in the tile-route cell, kept apart because
its host-paced runs spread wider than the dense cells' (the same
reader)."""

from pathlib import Path

from gpubench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "gteps")
