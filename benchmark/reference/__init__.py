"""Plain references that decide whether the program's outputs are correct.

They import neither the program nor JAX, and take nothing the program made.
"""
