"""Utilities: the command-line configuration."""
