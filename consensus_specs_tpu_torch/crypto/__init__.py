"""BLS and KZG for the port: the flush and the committee-key sums on the card
(`bls_torch`), the shim spec code calls (`bls`), the batched KZG checks
(`kzg_batch`), seeded mainnet-size inputs (`bls_synthetic`,
`msm_synthetic`), and copies of the JAX package's jax-free pure-Python
modules (`bls12_381`, `hash_to_curve`, `isogeny`, `bls_sig`, `kzg`), which
the port keeps so that it imports nothing of the JAX package."""
