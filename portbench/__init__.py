"""portbench: the benchmark of stormtpu_torch (one cell a run; see README.md)."""
