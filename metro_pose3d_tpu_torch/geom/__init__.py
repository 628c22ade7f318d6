"""Camera and skeleton geometry on the host (numpy only)."""
