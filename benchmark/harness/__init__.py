"""The harness: manifest, generators, the served requests, tracing and
the yardstick. Everything a cell, a configuration, a traffic mix or a
per-layer metric adds lives in files of its own, found by name."""
