"""Work counts of the benchmark's yardstick, from shapes alone."""
