"""The benchmark's harness: the manifest, the traffic generator, the window,
the trace reduction, the roofline arithmetic and the check of `correct`.
Nothing here imports jax or the JAX package; the port is imported only by
`cell.py`, which drives it."""
