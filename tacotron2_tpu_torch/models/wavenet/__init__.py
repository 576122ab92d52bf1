"""WaveNet vocoder."""
