"""Each stage's work from its shapes: (float32 operations, bytes), the
yardstick of the rooflines. It follows the algorithm, not a kernel, so a
rewrite of the kernel cannot move it."""
