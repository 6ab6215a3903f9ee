"""The plain reference of the benchmark's output check."""
