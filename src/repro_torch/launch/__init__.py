"""Launch layer: the serving entry point (``launch.serve``), the partition
count's device default (``launch.mesh``) and partition-axis rerouting
(``launch.elastic``)."""
