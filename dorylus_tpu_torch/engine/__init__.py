"""Batch building and the single-device epoch driver."""
