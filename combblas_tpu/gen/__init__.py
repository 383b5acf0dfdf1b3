"""Graph generators (R-MAT / Erdős–Rényi) — pure JAX, stateless PRNG."""
