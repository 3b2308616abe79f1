"""The benchmark of repro_torch: harness, graph generator, plain reference, per-layer readers."""
