"""Launch layer: the training and serving entry points (``launch.train``,
``launch.serve``), the partition count's device default (``launch.mesh``)
and partition-axis rerouting (``launch.elastic``)."""
