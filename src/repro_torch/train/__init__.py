"""Serve steps (training waits for a later slice)."""
