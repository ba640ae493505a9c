"""Utilities: weight conversion, checkpoints, metrics logging, renders."""
