"""``collective_ms.bits``: ``collective_ms`` in the tile-route cell, where it moves
``gteps.bits`` (the same reader)."""

from pathlib import Path

from gpubench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "collective_ms")
