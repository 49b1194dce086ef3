"""Checksummed persistent state and disk-pressure shedding."""
