"""Command-line tools: build_index, time_search, bench, gather_probe."""
