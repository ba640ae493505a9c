"""Experiment runners: the staged curriculum, the 2D fluid tasks, the CLI."""
