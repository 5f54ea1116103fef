"""Specs, factories, the plain forward and the served model objects."""
