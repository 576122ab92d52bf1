"""Tacotron-2 spectrogram prediction (synthesis path)."""
