"""The cell-independent parts of the benchmark."""
