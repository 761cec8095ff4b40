"""Single-agent host simulation loop."""
