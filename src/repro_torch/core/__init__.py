"""The pieces of `repro.core` that the serving engine uses, copied so the
port imports nothing of the JAX package. Each file names its source."""
