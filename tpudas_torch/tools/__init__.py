"""Measurement tools of the port: the HBM read probes and their harness."""
