"""Numerics kernels: reconstruction, Riemann solvers, EOS.

All ops are pure jnp functions over batched block arrays; XLA fuses the
elementwise stencil chains.
"""
