"""``device_idle_share.bits``: ``device_idle_share`` in the tile-route cell, where it moves
``gteps.bits`` (the same reader)."""

from pathlib import Path

from gpubench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "device_idle_share")
