"""The harness of the port's benchmark: the cells' drivers, the yardstick, the
weights the benchmark draws, the trace reduction and the data loaders."""
