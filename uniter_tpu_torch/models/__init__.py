"""Models: the UNITER trunk and task heads."""
