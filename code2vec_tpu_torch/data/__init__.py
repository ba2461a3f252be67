"""Host-side parsing of `.c2v` path-context rows."""
