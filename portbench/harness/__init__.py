"""The yardstick: what the benchmark runs around the program and reads from
it. Only ``system`` imports the program (``repro_torch``)."""
