"""Model parallelism: so far the Mixture-of-Experts layer, on one shard."""
