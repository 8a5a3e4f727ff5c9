"""Plain float32 references of the configurations' families, one module
each (``configs/<config>.json`` names it under ``reference``). They import
neither JAX nor any package of the program, and take the benchmark's own
weights and tokens."""
