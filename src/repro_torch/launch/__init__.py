"""Launch layer: the training and serving entry points (``launch.train``,
``launch.serve``), the meshes (``launch.mesh``: the ML device meshes, the
partition axis and its device default) and elastic moves
(``launch.elastic``: ``reshard_plan``, partition-axis rerouting)."""
