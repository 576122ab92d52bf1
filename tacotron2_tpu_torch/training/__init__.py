"""Training of the port: the WaveNet trainer."""
