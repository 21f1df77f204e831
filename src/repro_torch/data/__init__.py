"""Seeded synthetic data streams (numpy only)."""
