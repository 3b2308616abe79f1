"""Data plane: synthetic RDF graphs (the paper's sensor graphs, the
five-shape workload family and the figure graphs, byte-identical to the
reference generators for the same seed), the factorized corpus store
and the synthetic LM token pipeline."""
