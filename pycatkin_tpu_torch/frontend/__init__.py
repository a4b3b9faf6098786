"""Host-side mechanism description and the spec compiler (numpy only)."""
