"""Core integer numerics of the placement path: the rjenkins hashes,
crush_ln and its tables, stable_mod and the truncating s64 divide."""
