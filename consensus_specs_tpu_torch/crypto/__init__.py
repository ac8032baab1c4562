"""BLS for the port: the flush to the card (`bls_torch`), the shim spec code
calls (`bls`), seeded mainnet-size inputs (`bls_synthetic`), and copies of
the JAX package's jax-free pure-Python oracle (`bls12_381`,
`hash_to_curve`, `isogeny`, `bls_sig`, copied unchanged), which the port
keeps so that it imports nothing of the JAX package."""
