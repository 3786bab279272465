"""Host-side data: COCONUT loading, RLE codec, category tables, prefetching.
Copies of the JAX package's jax-free modules, so the port imports none of it."""
