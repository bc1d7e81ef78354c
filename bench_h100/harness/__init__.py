"""The benchmark's general code: what a run does, found by the names in
``BENCHMARK.json`` (configs, traffic mixes and metric readers are files
of their own beside this package)."""
