"""Vocabularies: word <-> index maps and the pickled vocab sidecar."""
