"""Core data model: Patch, attrs, time handling (host-side numpy)."""
