"""The stream round engine: configuration, runner and driver loop."""
