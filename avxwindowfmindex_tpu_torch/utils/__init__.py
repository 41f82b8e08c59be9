"""Host-side utilities: metrics registry, capacity planner, roofline."""
