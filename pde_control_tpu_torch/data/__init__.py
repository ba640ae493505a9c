"""Datasets: scene trees on disk, device-resident stores, generation."""
