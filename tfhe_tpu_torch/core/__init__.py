"""Core crypto of the port: params, torus numerics, randomness, entities,
NTT, algorithms."""
