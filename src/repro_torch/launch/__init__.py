"""Launch substrate: the mesh held on one card, and elastic replanning."""
