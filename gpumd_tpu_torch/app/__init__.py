"""Command-line applications: the `nep` and `gnep` trainers."""
