"""Model parallelism: the Mixture-of-Experts layer, expert-parallel over a
mesh axis."""
