"""Launch substrate: the mesh held on one card, elastic replanning, and
the serving launcher (``launch.serve``)."""
