"""The per-mode benchmarks of examples/benchmarking, over the port."""
