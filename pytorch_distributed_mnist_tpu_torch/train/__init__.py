"""Checkpoint IO of the port (training itself is not ported yet)."""
