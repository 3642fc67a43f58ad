"""Synthetic flows and windowed features."""
