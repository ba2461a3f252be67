"""Host-side parsing of `.c2v` path-context rows and the training reader."""
