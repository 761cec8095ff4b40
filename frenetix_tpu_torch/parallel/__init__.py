"""Multi-agent batching: all agents' replanning cycles in one device call."""
