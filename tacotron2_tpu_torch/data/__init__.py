"""Host-side input pipelines of the port."""
