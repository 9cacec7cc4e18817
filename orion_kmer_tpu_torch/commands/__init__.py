"""The port's subcommands: ``count`` and ``build``."""
