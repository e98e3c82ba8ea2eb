"""Treecode parameter sets."""
