"""Metrics of the port (a registry of counters and gauges)."""
