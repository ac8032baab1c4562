"""Input builders for the port's spec path (copies of what it needs from the
JAX package's testlib/): deterministic keys, blocks and a registry-scale
state with real keys."""
