"""The general window drivers, one per kind of traffic."""
