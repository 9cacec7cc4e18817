"""The port's subcommands: every one of the JAX package's CLI."""
