"""Launch layer: the serving driver (``launch.serve``)."""
