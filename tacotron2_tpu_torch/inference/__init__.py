"""Batch synthesis: text -> mel -> wav."""
