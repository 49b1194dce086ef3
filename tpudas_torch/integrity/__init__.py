"""Checksummed persistent state (the stream carry's files)."""
