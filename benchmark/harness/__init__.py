"""The harness: finds a cell's files by name, runs its closed loop of fits,
traces a slice of it, and decides whether its outputs are correct."""
