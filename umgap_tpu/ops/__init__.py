"""Device ops: encodings, 6-frame translation, k-mer packing, seed-extend,
and index probes. Pure-JAX formulations operating on fixed-shape integer
tensors, compiled by XLA."""
